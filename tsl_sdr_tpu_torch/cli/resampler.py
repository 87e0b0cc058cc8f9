"""resampler-torch: standalone rational resampler (reference
``resampler/resampler.c``), the port of ``resampler-tpu``.

Flags match ``resampler-tpu``: ``-I interp -D decim -S in_rate -F
filter.json [-b] [-p pole] [--fast] input output``, plus ``--device``;
int16 PCM in, int16 PCM at rate * I/D out.

    resampler-torch -I 147 -D 160 -F filt.json in48k.pcm out44k1.pcm
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

PROG = "resampler-torch"


def build_argparser():
    from tsl_sdr_tpu_torch.cli import cli_version

    p = argparse.ArgumentParser(prog=PROG, description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("-I", dest="interpolate", type=int, required=True)
    p.add_argument("-D", dest="decimate", type=int, required=True)
    p.add_argument("-S", dest="sample_rate", type=int, default=0)
    p.add_argument("-F", dest="filter_file", required=True)
    p.add_argument("-b", dest="dc_block", action="store_true")
    p.add_argument("-p", dest="dc_pole", type=float, default=0.9999)
    p.add_argument("--fast", dest="exact", action="store_false", default=True)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; fails without CUDA)")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("-V", "--version", action="version",
                   version=f"%(prog)s {cli_version()}")
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)

    from tsl_sdr_tpu_torch.runtime.stream import install_sigterm_as_interrupt

    install_sigterm_as_interrupt()

    from tsl_sdr_tpu_torch.utils.config import ConfigError, load_lpf_coeffs
    from tsl_sdr_tpu_torch.models.resampler import ResamplerChain
    from tsl_sdr_tpu_torch.runtime.stream import (PushResampler,
                                                  StreamCounters,
                                                  iter_file_blocks)

    try:
        coeffs = load_lpf_coeffs(args.filter_file)
    except ConfigError as e:
        print(f"{PROG}: {e}", file=sys.stderr)
        return 2
    chain = ResamplerChain(
        coeffs, args.interpolate, args.decimate,
        dc_block_pole=args.dc_pole if args.dc_block else None,
        exact=args.exact, device=args.device)
    resampler = PushResampler(chain)
    counters = StreamCounters()

    with open(args.output, "wb") as out:
        try:
            for block in iter_file_blocks(args.input):
                counters.samples_in += len(block)
                pcm = np.asarray(resampler.push(block), dtype=np.int16)
                counters.samples_out += pcm.size
                if pcm.size:
                    pcm.tofile(out)
                    out.flush()
            pcm = np.asarray(resampler.flush(), dtype=np.int16)
            counters.samples_out += pcm.size
            if pcm.size:
                pcm.tofile(out)
        except (KeyboardInterrupt, BrokenPipeError):
            pass
    print(f"{PROG}: {counters.summary()}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
