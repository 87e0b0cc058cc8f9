"""Signal-chain models: the production channelizer, the receive pipeline,
the decoders' resampler chain, and the POCSAG/FLEX/AIS decoders with BCH
(copies of ``tsl_sdr_tpu.models.{pocsag,flex,ais,bch}``, each on its native
C++ state machine unless built with ``native=False``).
"""
