"""Command-line tools of the port: ``pipeline-torch``."""
