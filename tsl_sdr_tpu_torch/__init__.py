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
* ``cli``     — ``pipeline-torch`` (file-capture mode), ``resampler-torch``
                and ``decoder-torch``.
* ``kernels`` — builds ``csrc/*.cu`` with ``nvcc`` at first use.
* ``utils``   — config, IQ, filter design and JSON output, and conversion
                of plans, chain state and stream state to and from the JAX
                package's.
* ``testing`` — the protocol generators and synthetic captures.

The package imports torch and numpy and nothing of jax or ``tsl_sdr_tpu``:
what it needs of the JAX package's jax-free modules it keeps as its own
copy, under the same module name.
"""

__version__ = "0.1.0"


def __getattr__(name):
    """``CostasChannelizer`` at top level, as the JAX package exports it,
    imported at first use (importing the package loads no model)."""
    if name == "CostasChannelizer":
        from tsl_sdr_tpu_torch.models.costas_channel import CostasChannelizer

        return CostasChannelizer
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
