"""Command-line tools of the port: ``pipeline-torch``, ``resampler-torch``
and ``decoder-torch``."""


def cli_version() -> str:
    """The port's version, with the git revision appended when running from
    a checkout."""
    import pathlib
    import subprocess

    from tsl_sdr_tpu_torch import __version__

    root = pathlib.Path(__file__).resolve().parents[2]
    try:
        rev = subprocess.run(
            ["git", "-C", str(root), "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=2).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return __version__
    return f"{__version__}+g{rev}" if rev else __version__
