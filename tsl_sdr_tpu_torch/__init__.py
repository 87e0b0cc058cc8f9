"""tsl_sdr_tpu_torch — the PyTorch + CUDA port of ``tsl_sdr_tpu``.

The JAX package beside it stays the reference; every module here keeps its
counterpart's path (``ops/packed_fir.py`` here ports
``tsl_sdr_tpu/ops/packed_fir.py``), and the tests hold each one against it.

* ``ops``     — the receive chain's stages on tensors: the fused
                channelizer+FM (``ops.chain``, CUDA kernel K1), the packed-row
                and frame-form resamplers (``ops.row_resampler`` and
                ``ops.frame_resampler``, CUDA kernels K3 and K4), the int8
                split that puts K1's and K3's products on the tensor cores
                (``ops.imma_split``), the DC blocker (its exact tier a CUDA
                kernel too), sync prefilters, plus the numpy plan builders.
* ``models``  — ``MultifmChain`` (both tiers), the streaming
                ``ReceivePipeline``, the decoders' ``ResamplerChain``, the
                coherent ``CostasChannelizer`` (CUDA kernel K6, the chunked
                Costas loop, ``ops.costas``), and the POCSAG/FLEX/AIS
                decoders and BCH.
* ``native``  — the decoders' C++ state machines (``tslstream.cc``).
* ``runtime`` — ``PushResampler`` and the CLIs' streaming helpers;
                ``runtime.native`` builds ``native/`` with g++ at first use.
* ``parallel``— meshes of devices, the sharded channelizer and resampler,
                ``ReceivePipeline(mesh=)``'s engine, and multi-process
                runs over ``torch.distributed`` (gloo).
* ``cli``     — ``pipeline-torch`` (file, live, bit-exact, mesh and
                multi-process modes), ``multifm-torch``,
                ``resampler-torch``, ``decoder-torch`` and
                ``design-filter-torch``.
* ``kernels`` — builds ``csrc/*.cu`` with ``nvcc`` at first use.
* ``utils``   — config, IQ, filter design, JSON output, diagnostics (the
                ``TSL_DUMP_LPF``/``TSL_DUMP_FILTER_COEFFICIENTS`` dumps,
                ``utils.diag``), and conversion
                of plans, chain state and stream state to and from the JAX
                package's.
* ``testing`` — the protocol generators and synthetic captures.

The package imports torch and numpy and nothing of jax or ``tsl_sdr_tpu``:
what it needs of the JAX package's jax-free modules it keeps as its own
copy, under the same module name.
"""

_LAZY = {
    "MultifmChain": ("tsl_sdr_tpu_torch.models.channelizer", "MultifmChain"),
    "ResamplerChain": ("tsl_sdr_tpu_torch.models.resampler",
                       "ResamplerChain"),
    "ReceivePipeline": ("tsl_sdr_tpu_torch.models.pipeline",
                        "ReceivePipeline"),
    "ChannelSpec": ("tsl_sdr_tpu_torch.models.pipeline", "ChannelSpec"),
    "PocsagDecoder": ("tsl_sdr_tpu_torch.models.pocsag", "PocsagDecoder"),
    "FlexDecoder": ("tsl_sdr_tpu_torch.models.flex", "FlexDecoder"),
    "AisDecoder": ("tsl_sdr_tpu_torch.models.ais", "AisDecoder"),
    "CostasChannelizer": ("tsl_sdr_tpu_torch.models.costas_channel",
                          "CostasChannelizer"),
    "MultifmConfig": ("tsl_sdr_tpu_torch.utils.config", "MultifmConfig"),
}


def __getattr__(name):
    """The JAX package's nine top-level names, each imported at first use
    (importing the package loads no model and no CUDA state), and
    ``__version__``, resolved at first use by ``_version`` (its git
    subprocess would otherwise tax every import)."""
    if name == "__version__":
        from tsl_sdr_tpu_torch._version import __version__ as v

        return v
    if name in _LAZY:
        import importlib

        mod, attr = _LAZY[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
