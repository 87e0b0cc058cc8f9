"""pipeline-torch: wideband IQ capture -> decoded messages, one process.

Port of ``pipeline-tpu`` (``tsl_sdr_tpu/cli/pipeline.py``) in file-capture
mode: one JSON config in the multifm vocabulary (each channel may carry
``"protocol": "pocsag" | "flex" | "ais" | "pcm"``), one capture file,
messages as JSON lines tagged with the channel's center frequency.

    pipeline-torch cfg.json --iq-file cap.cs16 -o out.jsonl

The live modes and the other flags of ``pipeline-tpu`` are not yet ported;
each exits with code 2 and says so.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

PROG = "pipeline-torch"
NOT_PORTED = "not yet ported to tsl_sdr_tpu_torch"

# pipeline-tpu flags this port does not have yet: (flag, takes a value)
_UNPORTED = (
    ("--exact", False), ("--backend", True), ("--follow", False),
    ("--no-drain-async", False), ("--state-file", True),
    ("--channel-shards", True), ("--time-shards", True),
    ("--distributed", True), ("--num-processes", True),
    ("--process-id", True), ("--stats", True), ("--standby", False),
    ("--no-warm", False), ("--idle-exit", True), ("--realtime", False),
)


def build_argparser():
    p = argparse.ArgumentParser(prog=PROG, description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("configs", nargs="+", help="JSON config file(s), merged")
    p.add_argument("--iq-file", default=None)
    p.add_argument("--iq-format", default=None,
                   choices=["cs16", "cs8", "cu8", "cu8_unbiased", "rtl_u8"])
    p.add_argument("-o", "--output", default=None, help="messages JSON file")
    p.add_argument("--block-size", type=int, default=None,
                   help="streaming block length in wideband samples")
    p.add_argument("--inflight-depth", type=int, default=2,
                   help="device blocks kept in flight before the oldest "
                        "is decoded")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; fails without CUDA)")
    p.add_argument("--iq-dump", default=None,
                   help="dump ingested wideband IQ (int16 values) to this "
                        "file — the reference's iqDumpFile tap")
    p.add_argument("--nmea", default=None, metavar="FILE",
                   help="emit NMEA 0183 !AIVDM sentences for every "
                        "CRC-valid packet on ais channels to FILE "
                        "('-' = stdout)")
    for flag, takes_value in _UNPORTED:
        p.add_argument(flag, default=None, help=f"({NOT_PORTED})",
                       **({} if takes_value else {"action": "store_true"}))
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)
    for flag, takes_value in _UNPORTED:
        value = getattr(args, flag.lstrip("-").replace("-", "_"))
        if (value is not None) if takes_value else value:
            print(f"{PROG}: {flag} is {NOT_PORTED}", file=sys.stderr)
            return 2

    from tsl_sdr_tpu_torch.utils import iq as iqio
    from tsl_sdr_tpu_torch.utils.config import (ConfigError, MultifmConfig,
                                                load_config)
    from tsl_sdr_tpu_torch.utils.jsonout import message_to_json
    from tsl_sdr_tpu_torch.models.pipeline import ChannelSpec, ReceivePipeline

    try:
        raw = load_config(*args.configs)
        cfg = MultifmConfig.from_dict(raw)
    except ConfigError as e:
        print(f"{PROG}: {e}", file=sys.stderr)
        return 2

    iq_path = args.iq_file
    fmt = args.iq_format
    if cfg.device.type == "file" and iq_path is None:
        iq_path = cfg.device.params["filename"]
        fmt = fmt or cfg.device.params.get("fileFormat", "cs16")
    if iq_path is None:
        print(f"{PROG}: need a file device or --iq-file (live hardware "
              f"sources are {NOT_PORTED})", file=sys.stderr)
        return 2
    fmt = fmt or "cs16"

    specs = [
        ChannelSpec(
            center_freq_hz=ch.chan_center_freq,
            protocol=str(ch_raw.get("protocol", "pcm")).lower(),
            invert=bool(ch_raw.get("invert", False)),
            dc_block=bool(ch_raw.get("dcBlock", False)),
            dc_block_pole=float(ch_raw.get("dcBlockPole", 0.9999)),
            db_gain=ch_raw.get("dBGain"),
        )
        for ch_raw, ch in zip(raw["channels"], cfg.channels)
    ]

    nmea_out = None
    ais_hook = None
    if args.nmea is not None:
        if not any(s.protocol == "ais" for s in specs):
            print(f"{PROG}: --nmea needs at least one ais channel",
                  file=sys.stderr)
            return 2
        from tsl_sdr_tpu_torch.models.ais import (NmeaEmitter,
                                                  aivdm_channel_for_freq)

        nmea_out = sys.stdout if args.nmea == "-" else open(args.nmea, "w")
        ais_hook = NmeaEmitter(nmea_out, channel=aivdm_channel_for_freq)

    # 8-bit captures ride the wire-format ingest path: raw bytes upload at
    # 2 B/sample and widen in the device step's first stage
    pipe = ReceivePipeline(
        cfg.lpf_taps, cfg.center_freq_hz, cfg.sample_rate_hz,
        cfg.decimation_factor, specs,
        block_size=args.block_size,
        inflight_depth=args.inflight_depth,
        ais_packet_hook=ais_hook,
        wire_fmt=fmt,
        device=args.device,
    )

    out = open(args.output, "w", buffering=1) if args.output else sys.stdout
    iq_dump = open(args.iq_dump, "wb") if args.iq_dump else None
    pcm_sinks = {
        i: open(ch.out_fifo, "wb")
        for i, (spec, ch) in enumerate(zip(specs, cfg.channels))
        if spec.protocol == "pcm" and ch.out_fifo
    }
    n_msgs = 0
    t0 = time.monotonic()
    try:
        if fmt == "cs16":
            iq = iqio.read_iq_file(iq_path, fmt)
            if iq_dump is not None:
                iq.tofile(iq_dump)
        else:
            raw_bytes = np.fromfile(iq_path, np.uint8)
            iq = raw_bytes[: len(raw_bytes) // 2 * 2].reshape(-1, 2)
            if iq_dump is not None:
                iqio.widen_iq_bytes(iq.reshape(-1), fmt).tofile(iq_dump)
        n_samples = len(iq)
        results = pipe.process_capture(iq)
        for i, (spec, res) in enumerate(zip(specs, results)):
            if spec.protocol == "pcm":
                sink = pcm_sinks.get(i)
                if sink is not None:
                    np.asarray(res, np.int16).tofile(sink)
                continue
            for m in res:
                out.write(message_to_json(m, freq_hz=spec.center_freq_hz)
                          + "\n")
                n_msgs += 1
        out.flush()
    finally:
        if out is not sys.stdout:
            out.close()
        for sink in pcm_sinks.values():
            sink.close()
        if iq_dump is not None:
            iq_dump.close()
        if nmea_out is not None and nmea_out is not sys.stdout:
            nmea_out.close()
    dt = time.monotonic() - t0
    print(f"{PROG}: {n_samples} samples, {len(specs)} channels, {n_msgs} "
          f"messages in {dt:.2f}s ({n_samples / max(dt, 1e-9) / 1e6:.1f} "
          "Msps)", file=sys.stderr)
    print(f"{PROG}: decoder tier {' '.join(sorted(pipe.decoder_tiers))}",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
