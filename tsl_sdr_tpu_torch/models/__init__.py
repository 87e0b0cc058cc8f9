"""Signal-chain models: the production channelizer and the receive pipeline.

The protocol decoders are the JAX package's own numpy modules
(``tsl_sdr_tpu.models.{pocsag,flex,ais,bch}``), reused as they are.
"""
