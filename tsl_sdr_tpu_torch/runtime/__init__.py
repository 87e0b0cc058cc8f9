"""Host runtime of the port: ``runtime.stream`` (``PushResampler`` and the
CLIs' streaming helpers) and ``runtime.native`` (the decoders' C++ state
machines). Importing this package loads neither."""
