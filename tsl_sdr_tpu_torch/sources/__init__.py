"""IQ source drivers: the port's copy of ``tsl_sdr_tpu/sources``.

The reference supports four sources
(``multifm/{rtl_sdr,airspy,uhd,file}_if.c``). The hardware drivers are
split into their pure, testable logic (config parsing, gain planning) and
the ctypes ingest loops of :mod:`.hw`, which dlopen the vendor library
and raise a clear error when it is missing.

File and FIFO ingest (real-time pacing, the 8-bit widenings) lives in
``pipeline-torch --follow`` (``cli/pipeline.py``) and
:mod:`tsl_sdr_tpu_torch.utils.iq`.
"""
