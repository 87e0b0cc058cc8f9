"""Signal-chain models: the production channelizer, the receive pipeline
and the decoders' resampler chain.

The protocol decoders are the JAX package's own numpy modules
(``tsl_sdr_tpu.models.{pocsag,flex,ais,bch}``), reused as they are.
"""
