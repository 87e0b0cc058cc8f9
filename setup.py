"""Build hooks: bake the git-describe version into built artifacts.

Equivalent of the reference's build-time version header + package stamp
(``/root/reference/CMakeLists.txt:37-47`` git-describe -> version.h;
``:110-125`` CPack metadata). A wheel/sdist built from a checkout carries
``tsl_sdr_tpu/_version_stamp.py`` with the exact commit; an installed
package reports it without needing git (see ``tsl_sdr_tpu/_version.py``).
The PyTorch port, ``tsl_sdr_tpu_torch``, gets the same stamp in its own
``_version_stamp.py`` (see ``tsl_sdr_tpu_torch/_version.py``).
"""

import os

from setuptools import setup
from setuptools.command.build_py import build_py as _build_py
from setuptools.command.sdist import sdist as _sdist

HERE = os.path.dirname(os.path.abspath(__file__))
STAMPED = ("tsl_sdr_tpu", "tsl_sdr_tpu_torch")


def _resolved_version() -> str:
    import sys

    sys.path.insert(0, HERE)
    try:
        from tsl_sdr_tpu._version import resolve_version

        return resolve_version()
    finally:
        sys.path.pop(0)


def _write_stamp(target_dir: str, version: str) -> None:
    os.makedirs(target_dir, exist_ok=True)
    with open(os.path.join(target_dir, "_version_stamp.py"), "w") as f:
        f.write(
            "# Generated at build time by setup.py (git describe stamp;\n"
            "# reference parity: CMakeLists.txt:37-47). Do not commit.\n"
            f"version = {version!r}\n"
        )


class build_py(_build_py):
    def run(self):
        super().run()
        for pkg in STAMPED:
            _write_stamp(os.path.join(self.build_lib, pkg),
                         self.distribution.metadata.version)


class sdist(_sdist):
    def make_release_tree(self, base_dir, files):
        super().make_release_tree(base_dir, files)
        for pkg in STAMPED:
            _write_stamp(os.path.join(base_dir, pkg),
                         self.distribution.metadata.version)


setup(version=_resolved_version(), cmdclass={"build_py": build_py,
                                             "sdist": sdist})
