"""design-filter-torch: rational-resampler filter designer.

Port of ``design-filter-tpu`` (``tsl_sdr_tpu/cli/design_filter.py``): a
Kaiser (beta 7) low-pass at the interpolated rate, the design of the
reference's ``scripts/design_interpolation_filter.py`` without GNURadio,
printed as the same JSON document (the ``-F`` file of ``decoder-torch`` and
``resampler-torch``). It touches no device.

Usage: design-filter-torch INTERPOLATION DECIMATION FRACTIONAL_BW
"""

from __future__ import annotations

import sys


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] in ("-V", "--version"):
        from tsl_sdr_tpu_torch.cli import cli_version

        print(f"design-filter-torch {cli_version()}")
        return 0
    if len(argv) < 3:
        print(
            "Usage: design-filter-torch [interpolation] [decimation] "
            "[fractional bandwidth]\n"
            "  Design a filter for use with a rational resampler",
            file=sys.stderr,
        )
        return 1
    from tsl_sdr_tpu_torch.utils.filter_design import resampler_filter_json

    print(resampler_filter_json(int(argv[0]), int(argv[1]), float(argv[2])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
