"""tsl_sdr_tpu_torch — the PyTorch + CUDA port of ``tsl_sdr_tpu``.

The JAX package beside it stays the reference; every module here keeps its
counterpart's path (``ops/packed_fir.py`` here ports
``tsl_sdr_tpu/ops/packed_fir.py``), and the tests hold each one against it.

* ``ops``     — the receive chain's stages on tensors: the fused
                channelizer+FM (``ops.chain``, CUDA kernel K1), the packed-row
                and frame-form resamplers (``ops.row_resampler`` and
                ``ops.frame_resampler``, CUDA kernels K3 and K4), the DC
                blocker (its exact tier a CUDA kernel too), sync prefilters,
                plus the numpy plan builders.
* ``models``  — ``MultifmChain`` (production tier), the streaming
                ``ReceivePipeline`` and the decoders' ``ResamplerChain``.
* ``runtime`` — ``PushResampler`` and the CLIs' streaming helpers.
* ``cli``     — ``pipeline-torch`` (file-capture mode), ``resampler-torch``
                and ``decoder-torch``.
* ``kernels`` — builds ``csrc/*.cu`` with ``nvcc`` at first use.
* ``utils``   — conversion of plans, chain state and stream state to and
                from the JAX package's.

The package imports torch and numpy, never jax: the protocol decoders,
signal generators and config/IQ utilities are reused from the JAX package's
jax-free modules.
"""
