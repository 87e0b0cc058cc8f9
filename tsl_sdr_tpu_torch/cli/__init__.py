"""Command-line tools of the port: ``pipeline-torch``, ``resampler-torch``
and ``decoder-torch``."""
