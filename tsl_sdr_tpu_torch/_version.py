"""The port's version: the build's ``git describe`` stamp, as the JAX
package's ``_version`` gives it.

Resolution order:

1. ``tsl_sdr_tpu_torch/_version_stamp.py``, written by the sdist and wheel
   builds (``setup.py``'s ``build_py`` and ``sdist`` hooks), so an installed
   package reports the commit it was built from without a checkout.
2. Live ``git describe --tags --always --dirty`` when running from a
   checkout, normalized to a PEP 440 local version (e.g.
   ``0.1.0+gf5b2b22.dirty``).
3. The static base version.
"""

from __future__ import annotations

import os
import re
import subprocess

BASE_VERSION = "0.1.0"


def git_describe(repo_dir: str | None = None) -> str | None:
    """``git describe --tags --always --dirty`` of the containing repo,
    or None outside a checkout or without git."""
    if repo_dir is None:
        repo_dir = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    try:
        out = subprocess.run(
            ["git", "-C", repo_dir, "describe", "--tags", "--always",
             "--dirty"],
            capture_output=True, text=True, timeout=10)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if out.returncode != 0:
        return None
    return out.stdout.strip() or None


def describe_to_pep440(desc: str, base: str = BASE_VERSION) -> str:
    """Normalize a git-describe string to PEP 440.

    ``v0.1.0`` -> ``0.1.0``; ``v0.1.0-3-gabc123`` -> ``0.1.0.post3+gabc123``;
    an untagged ``abc123[-dirty]`` -> ``<base>+gabc123[.dirty]``.
    """
    dirty = desc.endswith("-dirty")
    if dirty:
        desc = desc[: -len("-dirty")]
    m = re.fullmatch(r"v?(\d+(?:\.\d+)*)(?:-(\d+)-g([0-9a-f]+))?", desc)
    if m:
        ver, n, sha = m.groups()
        local = []
        if n and int(n):
            ver = f"{ver}.post{n}"
            local.append(f"g{sha}")
    else:
        # a bare hash: no tag anywhere in the history
        ver = base
        local = [f"g{desc}"]
    if dirty:
        local.append("dirty")
    return ver + (("+" + ".".join(local)) if local else "")


def resolve_version() -> str:
    try:
        from tsl_sdr_tpu_torch._version_stamp import (  # noqa: PLC0415
            version as stamped)

        return stamped
    except ImportError:
        pass
    desc = git_describe()
    if desc:
        return describe_to_pep440(desc)
    return BASE_VERSION


__version__ = resolve_version()
