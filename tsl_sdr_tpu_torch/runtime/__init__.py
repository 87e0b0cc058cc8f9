"""Host streaming helpers of the port (``runtime.stream``)."""
