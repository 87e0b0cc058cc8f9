"""decoder-torch: FLEX / POCSAG / AIS decoder (reference
``decoder/decoder.c``), the port of ``decoder-tpu``.

Same flags as ``decoder-tpu``: ``-m {flex,pocsag,ais} -I interp -D decim
-S in_rate -F filter.json -f freq_hz [-b] [-p pole] [-i] [-d pcm_dump]
[-o out.json] [-c] [--nmea FILE] [--nmea-channel A|B] [--fast] input``,
plus ``--device``. Reads int16 PCM from a file or FIFO, polyphase-resamples
to the protocol rate on the device, optionally DC-blocks, runs the
protocol state machine (``models.{flex,pocsag,ais}``) and emits one
JSON object per message.

    decoder-torch -m flex -I 16 -D 25 -F etc/flex_16_25.json -o out.json in.pcm
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

PROG = "decoder-torch"


def build_argparser():
    from tsl_sdr_tpu_torch.cli import cli_version

    p = argparse.ArgumentParser(prog=PROG, description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("-m", dest="mode", required=True,
                   choices=["flex", "pocsag", "ais"], type=str.lower)
    p.add_argument("-I", dest="interpolate", type=int, default=1)
    p.add_argument("-D", dest="decimate", type=int, default=1)
    p.add_argument("-S", dest="sample_rate", type=int, default=0)
    p.add_argument("-F", dest="filter_file", required=True)
    p.add_argument("-f", dest="freq", type=int, default=0,
                   help="channel center frequency (labeling only)")
    p.add_argument("-b", dest="dc_block", action="store_true")
    p.add_argument("-p", dest="dc_pole", type=float, default=0.9999)
    p.add_argument("-i", dest="invert", action="store_true")
    p.add_argument("-d", dest="pcm_dump", default=None)
    p.add_argument("-o", dest="out_file", default=None)
    p.add_argument("-c", dest="create_out", action="store_true")
    p.add_argument("--nmea", default=None, metavar="FILE",
                   help="AIS only: also emit NMEA 0183 !AIVDM sentences to "
                        "FILE ('-' = stdout)")
    p.add_argument("--nmea-channel", default="A", choices=["A", "B"],
                   help="VHF channel letter stamped into --nmea sentences")
    p.add_argument("--exact", action="store_true", default=True)
    p.add_argument("--fast", dest="exact", action="store_false",
                   help="float fast tier for the resampler front-end")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; fails without CUDA)")
    p.add_argument("input", help="input PCM file or FIFO")
    p.add_argument("-V", "--version", action="version",
                   version=f"%(prog)s {cli_version()}")
    return p


def _protocol(mode: str, freq: int):
    from tsl_sdr_tpu_torch.utils import jsonout

    if mode == "flex":
        from tsl_sdr_tpu_torch.models.flex import FlexDecoder

        return FlexDecoder(freq_hz=freq), jsonout.flex_message_json
    if mode == "pocsag":
        from tsl_sdr_tpu_torch.models.pocsag import PocsagDecoder

        return PocsagDecoder(), jsonout.pocsag_message_json
    from tsl_sdr_tpu_torch.models.ais import AisDecoder

    return AisDecoder(), jsonout.ais_message_json


def main(argv=None):
    args = build_argparser().parse_args(argv)

    from tsl_sdr_tpu_torch.runtime.stream import install_sigterm_as_interrupt

    install_sigterm_as_interrupt()

    from tsl_sdr_tpu_torch.utils.config import ConfigError, load_lpf_coeffs
    from tsl_sdr_tpu_torch.models.resampler import ResamplerChain
    from tsl_sdr_tpu_torch.runtime.stream import (PushResampler,
                                                  StreamCounters,
                                                  iter_file_blocks)

    proto, to_json = _protocol(args.mode, args.freq)
    if args.nmea is not None and args.mode != "ais":
        print(f"{PROG}: --nmea applies to -m ais only", file=sys.stderr)
        return 2
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

    nmea_out = None
    if args.nmea is not None:
        # opened only after the config validated: a bad config must not
        # truncate an existing NMEA feed file
        from tsl_sdr_tpu_torch.models.ais import NmeaEmitter

        nmea_out = sys.stdout if args.nmea == "-" else open(args.nmea, "w")
        proto.packet_hook = NmeaEmitter(nmea_out, channel=args.nmea_channel)

    out = sys.stdout if args.out_file is None else open(
        args.out_file, "w" if args.create_out else "a")
    dump = open(args.pcm_dump, "wb") if args.pcm_dump else None
    counters = StreamCounters()
    decode = getattr(proto, "scan", proto.on_pcm)

    def handle(pcm):
        if pcm.size == 0:
            return
        pcm = np.asarray(pcm, dtype=np.int16)
        counters.samples_out += pcm.size
        if dump is not None:
            pcm.tofile(dump)
        for msg in decode(pcm):
            counters.messages += 1
            line = to_json(msg)
            if line:
                out.write(line + "\n")
                out.flush()

    try:
        for block in iter_file_blocks(args.input):
            counters.samples_in += len(block)
            if args.invert:
                block = (-block.astype(np.int32)).astype(np.int16)
            handle(resampler.push(block))
        handle(resampler.flush())
    except KeyboardInterrupt:
        pass
    finally:
        counters.crc_rejects = getattr(proto, "crc_rejects", 0)
        print(f"{PROG}: {counters.summary()}", file=sys.stderr)
        tier = "native" if proto._nat is not None else "numpy"
        print(f"{PROG}: decoder tier {tier}", file=sys.stderr)
        if out is not sys.stdout:
            out.close()
        if nmea_out is not None and nmea_out is not sys.stdout:
            nmea_out.close()
        if dump is not None:
            dump.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
