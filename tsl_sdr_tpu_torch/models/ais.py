"""AIS receiver: GMSK/NRZI demodulator + AIVDM message decoder.

Replicates the reference pair (``ais/ais_demod.c``, ``ais/ais_decode.c``):

* 48 kHz PCM in, 9600 bps -> blind decimate-by-5. Preamble hunt: five
  phase-interleaved shift registers of NRZI-decoded bits
  (``bit = !(last ^ cur)``) matched against 0x5555557E (preamble + HDLC
  start flag) within 2 errors on >= 3 of 5 phases (ais_demod.c:114-157).
* RECEIVING: one NRZI bit per 5 samples, HDLC bit-unstuffing (a 0 after
  five 1s is dropped), bytes filled LSB-first; end on the 0x7E flag in the
  decoded shift register or 1280-bit overflow; CRC-16/X.25 over all but the
  last 2 bytes (ais_demod.c:160-213).
* Field decode: MSB-first bitfield extraction over the byte array; message
  types 1/2/3 (position report), 4 (base station report), 5 (static +
  voyage data); 6-bit ASCII strings; AIVDM ASCII-armored raw payload
  (ais_decode.c:23-290).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from tsl_sdr_tpu_torch.runtime.native import AisNative

DECIMATION = 5
PREAMBLE_PATTERN = 0x5555557E
END_FLAG = 0x7E
MAX_PACKET_BITS = 5 * 256

EPFD_NAMES = [
    "Undefined", "GPS", "GLONASS", "Combined GPS/GLONASS", "Loran-C",
    "Chayka", "Integrated Navigation System", "Surveyed", "Galileo",
    "Unknown 9", "Unknown 10", "Unknown 11", "Unknown 12", "Unknown 13",
    "Unknown 14", "Unknown 15",
]


def _make_crc16_x25_table():
    tab = []
    for b in range(256):
        crc = b
        for _ in range(8):
            crc = (crc >> 1) ^ 0x8408 if crc & 1 else crc >> 1
        tab.append(crc)
    return tab


_CRC16_X25_TABLE = _make_crc16_x25_table()


def crc16_x25(data: bytes) -> int:
    """CRC-16/X.25 (poly 0x8408 reflected, init 0xFFFF, final complement) —
    matches ``ais_demod.c:18-36`` (table-driven, same polynomial walk)."""
    crc = 0xFFFF
    tab = _CRC16_X25_TABLE
    for b in data:
        crc = (crc >> 8) ^ tab[(crc ^ b) & 0xFF]
    return (~crc) & 0xFFFF


def get_bitfield(packet: bytes, offset: int, length: int) -> int:
    """MSB-first bitfield extraction (``ais_decode.c:23-47``)."""
    start = offset // 8
    end = (offset + length + 7) // 8
    acc = 0
    for i in range(start, end):
        acc = (acc << 8) | packet[i]
    acc >>= (end * 8) - (offset + length)
    return acc & ((1 << length) - 1)


def get_bitfield_signed(packet: bytes, offset: int, length: int) -> int:
    v = get_bitfield(packet, offset, length)
    if v & (1 << (length - 1)):
        v -= 1 << length
    return v


def get_string(packet: bytes, offset: int, nr_chars: int) -> str:
    out = []
    for i in range(nr_chars):
        v = get_bitfield(packet, offset + 6 * i, 6)
        out.append(chr(v if v > 0x1F else v + 0x40))
    return "".join(out)


def get_string_to_end(packet: bytes, offset: int) -> str:
    """6-bit string from ``offset`` to the end of the payload, trailing
    '@' padding stripped — types 12/14 carry variable-length text
    (beyond-reference; reference decodes fixed fields only,
    ``ais_decode.c:58-72``). Only '@' is the pad character per ITU-R
    M.1371; trailing spaces are representable payload and are kept."""
    n = (len(packet) * 8 - offset) // 6
    return get_string(packet, offset, n).rstrip("@")


def _payload_hex(packet: bytes, offset: int,
                 end: int | None = None) -> tuple[str, int]:
    """Left-aligned hex of bits ``offset..end`` (default: packet end) —
    the opaque application payload of binary messages — plus its exact
    bit length."""
    nbits = (len(packet) * 8 if end is None else end) - offset
    if nbits <= 0:
        return "", 0
    nbytes = (nbits + 7) // 8
    v = get_bitfield(packet, offset, nbits) << (nbytes * 8 - nbits)
    return v.to_bytes(nbytes, "big").hex(), nbits


def ascii_armor(packet: bytes) -> str:
    """AIVDM 6-bit ASCII armor of the raw payload (``ais_decode.c:217-259``)."""
    out = []
    offs = 0
    n = len(packet)
    while offs < n:
        accum = 0
        for j in range(offs, min(offs + 3, n)):
            accum = (accum << 8) | packet[j]
        offs += 3
        for j in range(4):
            v = (accum >> ((3 - j) * 6)) & 0x3F
            out.append(chr(v + 48 if v <= 39 else v - 40 + 96))
    return "".join(out)


@dataclass
class AisPositionReport:
    mmsi: int
    nav_stat: int
    rate_of_turn: int
    speed_over_ground: float
    position_acc: int
    longitude: float
    latitude: float
    course: int
    heading: int
    timestamp: int
    msg_id: int = 1
    repeat: int = 0
    raw: str = ""


@dataclass
class AisBaseStationReport:
    mmsi: int
    year: int
    month: int
    day: int
    hour: int
    minute: int
    second: int
    longitude: float
    latitude: float
    epfd_type: int
    epfd_name: str = ""
    msg_id: int = 4  # 11 = UTC/date response (same layout, mobile station)
    raw: str = ""


@dataclass
class AisStaticVoyageData:
    mmsi: int
    version: int
    imo_number: int
    callsign: str
    ship_name: str
    ship_type: int
    dim_to_bow: int
    dim_to_stern: int
    dim_to_port: int
    dim_to_starboard: int
    fix_type: int
    eta_month: int
    eta_day: int
    eta_hour: int
    eta_minute: int
    draught: float
    destination: str
    epfd_name: str = ""
    raw: str = ""


@dataclass
class AisClassBPositionReport:
    """Type 18 (Class B equipment position report) — a beyond-reference
    extension (the reference decodes only types 1-5); field layout per
    ITU-R M.1371-5 table 46, same unit conventions as the type 1/2/3
    decoder above."""

    mmsi: int
    speed_over_ground: float
    position_acc: int
    longitude: float
    latitude: float
    course: int
    heading: int
    timestamp: int
    repeat: int = 0
    raw: str = ""


@dataclass
class AisStaticDataReport:
    """Type 24 (Class B static data report, part A or B) — beyond-reference
    extension; layout per ITU-R M.1371-5 table 57/58."""

    mmsi: int
    part: str                 # "A" | "B"
    ship_name: str = ""       # part A
    ship_type: int = 0        # part B
    vendor_id: str = ""       # part B
    callsign: str = ""        # part B
    dim_to_bow: int = 0
    dim_to_stern: int = 0
    dim_to_port: int = 0
    dim_to_starboard: int = 0
    repeat: int = 0
    raw: str = ""


@dataclass
class AisAidToNavigationReport:
    """Type 21 (aid-to-navigation report) — beyond-reference extension;
    layout per ITU-R M.1371-5 table 74."""

    mmsi: int
    aid_type: int
    name: str
    position_acc: int
    longitude: float
    latitude: float
    dim_to_bow: int
    dim_to_stern: int
    dim_to_port: int
    dim_to_starboard: int
    epfd_type: int
    timestamp: int
    off_position: bool
    virtual_aid: bool
    repeat: int = 0
    raw: str = ""


@dataclass
class AisSarAircraftReport:
    """Type 9 (SAR aircraft position report) — beyond-reference extension;
    layout per ITU-R M.1371-5 table 49. Altitude in metres (4095 = not
    available); SOG in whole knots (1023 = not available)."""

    mmsi: int
    altitude: int
    speed_over_ground: float
    position_acc: int
    longitude: float
    latitude: float
    course: int
    timestamp: int
    repeat: int = 0
    raw: str = ""


@dataclass
class AisExtendedClassBReport:
    """Type 19 (extended Class B position report) — beyond-reference
    extension; layout per ITU-R M.1371-5 table 47: the type-18 kinematics
    plus name/type/dimensions (a one-message Class B static+position)."""

    mmsi: int
    speed_over_ground: float
    position_acc: int
    longitude: float
    latitude: float
    course: int
    heading: int
    timestamp: int
    name: str
    ship_type: int
    dim_to_bow: int
    dim_to_stern: int
    dim_to_port: int
    dim_to_starboard: int
    epfd_type: int
    repeat: int = 0
    raw: str = ""


@dataclass
class AisLongRangePositionReport:
    """Type 27 (long-range broadcast position report) — beyond-reference
    extension; layout per ITU-R M.1371-5 table 96. Coarse 1/10-minute
    position, 6-bit SOG, 9-degree-resolution COG."""

    mmsi: int
    position_acc: int
    raim: bool
    nav_stat: int
    longitude: float
    latitude: float
    speed_over_ground: float
    course: int
    repeat: int = 0
    raw: str = ""


@dataclass
class AisSafetyMessage:
    """Type 14 (safety-related broadcast) / type 12 (addressed safety
    message) — beyond-reference extension; ITU-R M.1371-5 §§ M.3.10/3.12.
    ``dest_mmsi`` is None for the broadcast form."""

    mmsi: int
    text: str
    dest_mmsi: int | None = None
    seqno: int = 0
    retransmit: bool = False
    repeat: int = 0
    raw: str = ""


@dataclass
class AisBinaryMessage:
    """Type 8 (binary broadcast) / type 6 (addressed binary message) —
    beyond-reference extension. The application payload is opaque to the
    transport layer: carried as left-aligned hex plus its exact bit
    length, keyed by DAC/FI. ``dest_mmsi`` is None for the broadcast
    form."""

    mmsi: int
    dac: int
    fi: int
    data: str
    data_bits: int
    dest_mmsi: int | None = None
    seqno: int = 0
    retransmit: bool = False
    repeat: int = 0
    raw: str = ""


@dataclass
class AisAcknowledge:
    """Type 7 (binary acknowledge) / type 13 (safety acknowledge) —
    beyond-reference extension; layout per ITU-R M.1371-5 §§ M.3.7/3.11:
    1-4 (dest_mmsi, sequence) pairs."""

    mmsi: int
    acks: list  # [(dest_mmsi, seqno), ...]
    msg_id: int = 7
    repeat: int = 0
    raw: str = ""


@dataclass
class AisUtcInquiry:
    """Type 10 (UTC/date inquiry) — beyond-reference extension;
    ITU-R M.1371-5 § M.3.9 (72 bits)."""

    mmsi: int
    dest_mmsi: int
    repeat: int = 0
    raw: str = ""


@dataclass
class AisInterrogation:
    """Type 15 (interrogation) — beyond-reference extension;
    ITU-R M.1371-5 § M.3.13: up to two stations interrogated for
    specific message types at slot offsets."""

    mmsi: int
    targets: list  # [(dest_mmsi, msg_type, slot_offset), ...]
    repeat: int = 0
    raw: str = ""


@dataclass
class AisAssignmentCommand:
    """Type 16 (assignment mode command) — beyond-reference extension;
    ITU-R M.1371-5 § M.3.14: 1-2 (dest_mmsi, offset, increment)
    assignments."""

    mmsi: int
    assignments: list  # [(dest_mmsi, slot_offset, increment), ...]
    repeat: int = 0
    raw: str = ""


@dataclass
class AisDgnssBroadcast:
    """Type 17 (DGNSS broadcast binary message) — beyond-reference
    extension; ITU-R M.1371-5 § M.3.15: reference position in 1/10-minute
    units plus the opaque DGNSS correction payload."""

    mmsi: int
    longitude: float
    latitude: float
    data: str
    data_bits: int
    repeat: int = 0
    raw: str = ""


@dataclass
class AisSlotBinaryMessage:
    """Type 25 (single-slot binary message) / type 26 (multi-slot binary
    message with comm state) — beyond-reference extension; ITU-R M.1371-5
    §§ M.3.22/3.23. Optional addressing and optional 16-bit application
    id; type 26 carries a trailing 20-bit radio/comm state."""

    mmsi: int
    data: str
    data_bits: int
    msg_id: int = 25
    addressed: bool = False
    structured: bool = False
    dest_mmsi: int | None = None
    app_id: int | None = None
    radio_status: int | None = None  # type 26 only
    repeat: int = 0
    raw: str = ""


@dataclass
class AisDataLinkManagement:
    """Type 20 (data link management) — beyond-reference extension;
    ITU-R M.1371-5 § M.3.18: up to 4 FATDMA reservation blocks."""

    mmsi: int
    reservations: list  # [(slot_offset, number, timeout, increment), ...]
    repeat: int = 0
    raw: str = ""


@dataclass
class AisChannelManagement:
    """Type 22 (channel management) — beyond-reference extension;
    ITU-R M.1371-5 § M.3.20. Broadcast form carries a NE/SW region;
    addressed form carries two destination MMSIs instead."""

    mmsi: int
    channel_a: int
    channel_b: int
    txrx_mode: int
    power: int
    addressed: bool
    ne_lon: float = 0.0
    ne_lat: float = 0.0
    sw_lon: float = 0.0
    sw_lat: float = 0.0
    dest1: int = 0
    dest2: int = 0
    band_a: int = 0
    band_b: int = 0
    zone_size: int = 0
    repeat: int = 0
    raw: str = ""


@dataclass
class AisGroupAssignment:
    """Type 23 (group assignment command) — beyond-reference extension;
    ITU-R M.1371-5 § M.3.21: regional operating assignment for a station
    group selected by region/type."""

    mmsi: int
    ne_lon: float
    ne_lat: float
    sw_lon: float
    sw_lat: float
    station_type: int
    ship_type: int
    txrx_mode: int
    interval: int
    quiet_time: int
    repeat: int = 0
    raw: str = ""


# minimum payload length (bits) actually read per message type; the
# reference instead BUG_ONs on a short read (ais_decode.c:34) — fatal by
# design there, but a run-forever pipeline must survive the ~1/65536 noise
# packets whose CRC collides, so short packets are rejected, not crashed on
_MIN_BITS = {1: 143, 2: 143, 3: 143, 4: 138, 5: 422, 6: 88, 7: 72, 8: 56,
             9: 134, 10: 70, 11: 138, 12: 72, 13: 72, 14: 40, 15: 88,
             16: 92, 17: 80, 18: 139, 19: 305, 20: 70, 21: 270, 22: 145,
             23: 154, 24: 160, 25: 40, 26: 60, 27: 94}


def decode_fields(packet: bytes):
    """Packet bytes (CRC stripped) -> typed report, or None for other
    types or for packets too short to carry their type's fields."""
    if len(packet) < 5:
        return None
    msg_id = (packet[0] >> 2) & 0x3F
    need = _MIN_BITS.get(msg_id)
    if need is not None and len(packet) * 8 < need:
        return None
    repeat = packet[0] & 0x3
    mmsi = (
        (packet[1] << 22)
        | (packet[2] << 14)
        | (packet[3] << 6)
        | ((packet[4] >> 2) & 0x3F)
    )
    raw = ascii_armor(packet)
    if msg_id in (1, 2, 3):
        return AisPositionReport(
            mmsi=mmsi,
            nav_stat=get_bitfield(packet, 38, 4),
            rate_of_turn=get_bitfield_signed(packet, 42, 8),
            speed_over_ground=get_bitfield(packet, 50, 10) / 10.0,
            position_acc=get_bitfield(packet, 60, 1),
            longitude=get_bitfield_signed(packet, 61, 28) / 600000.0,
            latitude=get_bitfield_signed(packet, 89, 27) / 600000.0,
            course=get_bitfield(packet, 116, 12),
            heading=get_bitfield(packet, 128, 9),
            timestamp=get_bitfield(packet, 137, 6),
            msg_id=msg_id,
            repeat=repeat,
            raw=raw,
        )
    if msg_id == 18:
        return AisClassBPositionReport(
            mmsi=mmsi,
            speed_over_ground=get_bitfield(packet, 46, 10) / 10.0,
            position_acc=get_bitfield(packet, 56, 1),
            longitude=get_bitfield_signed(packet, 57, 28) / 600000.0,
            latitude=get_bitfield_signed(packet, 85, 27) / 600000.0,
            course=get_bitfield(packet, 112, 12),
            heading=get_bitfield(packet, 124, 9),
            timestamp=get_bitfield(packet, 133, 6),
            repeat=repeat,
            raw=raw,
        )
    if msg_id in (4, 11):  # type 11 = UTC/date response, same layout
        epfd = get_bitfield(packet, 134, 4)
        return AisBaseStationReport(
            mmsi=mmsi,
            msg_id=msg_id,
            year=get_bitfield(packet, 38, 14),
            month=get_bitfield(packet, 52, 4),
            day=get_bitfield(packet, 56, 5),
            hour=get_bitfield(packet, 61, 5),
            minute=get_bitfield(packet, 66, 6),
            second=get_bitfield(packet, 72, 6),
            longitude=get_bitfield_signed(packet, 79, 28) / 600000.0,
            latitude=get_bitfield_signed(packet, 107, 27) / 600000.0,
            epfd_type=epfd,
            epfd_name=EPFD_NAMES[epfd & 0xF],
            raw=raw,
        )
    if msg_id == 24:
        part = get_bitfield(packet, 38, 2)
        if part == 0:
            return AisStaticDataReport(
                mmsi=mmsi, part="A",
                ship_name=get_string(packet, 40, 20),
                repeat=repeat, raw=raw,
            )
        if len(packet) * 8 < 162:  # part B reads past the part-A span
            return None
        return AisStaticDataReport(
            mmsi=mmsi, part="B",
            ship_type=get_bitfield(packet, 40, 8),
            vendor_id=get_string(packet, 48, 7),
            callsign=get_string(packet, 90, 7),
            dim_to_bow=get_bitfield(packet, 132, 9),
            dim_to_stern=get_bitfield(packet, 141, 9),
            dim_to_port=get_bitfield(packet, 150, 6),
            dim_to_starboard=get_bitfield(packet, 156, 6),
            repeat=repeat, raw=raw,
        )
    if msg_id == 5:
        fix = get_bitfield(packet, 270, 4)
        return AisStaticVoyageData(
            mmsi=mmsi,
            version=get_bitfield(packet, 38, 2),
            imo_number=get_bitfield(packet, 40, 30),
            callsign=get_string(packet, 70, 7),
            ship_name=get_string(packet, 112, 20),
            ship_type=get_bitfield(packet, 232, 8),
            dim_to_bow=get_bitfield(packet, 240, 9),
            dim_to_stern=get_bitfield(packet, 249, 9),
            dim_to_port=get_bitfield(packet, 258, 6),
            dim_to_starboard=get_bitfield(packet, 264, 6),
            fix_type=fix,
            eta_month=get_bitfield(packet, 274, 4),
            eta_day=get_bitfield(packet, 278, 5),
            eta_hour=get_bitfield(packet, 283, 5),
            eta_minute=get_bitfield(packet, 288, 6),
            draught=get_bitfield(packet, 294, 8) / 10.0,
            destination=get_string(packet, 302, 20),
            epfd_name=EPFD_NAMES[fix & 0xF],
            raw=raw,
        )
    if msg_id == 21:
        return AisAidToNavigationReport(
            mmsi=mmsi,
            aid_type=get_bitfield(packet, 38, 5),
            name=get_string(packet, 43, 20),
            position_acc=get_bitfield(packet, 163, 1),
            longitude=get_bitfield_signed(packet, 164, 28) / 600000.0,
            latitude=get_bitfield_signed(packet, 192, 27) / 600000.0,
            dim_to_bow=get_bitfield(packet, 219, 9),
            dim_to_stern=get_bitfield(packet, 228, 9),
            dim_to_port=get_bitfield(packet, 237, 6),
            dim_to_starboard=get_bitfield(packet, 243, 6),
            epfd_type=get_bitfield(packet, 249, 4),
            timestamp=get_bitfield(packet, 253, 6),
            off_position=bool(get_bitfield(packet, 259, 1)),
            virtual_aid=bool(get_bitfield(packet, 269, 1)),
            repeat=repeat,
            raw=raw,
        )
    if msg_id == 14:
        return AisSafetyMessage(
            mmsi=mmsi, text=get_string_to_end(packet, 40),
            repeat=repeat, raw=raw,
        )
    if msg_id == 12:
        return AisSafetyMessage(
            mmsi=mmsi,
            seqno=get_bitfield(packet, 38, 2),
            dest_mmsi=get_bitfield(packet, 40, 30),
            retransmit=bool(get_bitfield(packet, 70, 1)),
            text=get_string_to_end(packet, 72),
            repeat=repeat, raw=raw,
        )
    if msg_id == 8:
        data, nbits = _payload_hex(packet, 56)
        return AisBinaryMessage(
            mmsi=mmsi,
            dac=get_bitfield(packet, 40, 10),
            fi=get_bitfield(packet, 50, 6),
            data=data, data_bits=nbits,
            repeat=repeat, raw=raw,
        )
    if msg_id == 6:
        data, nbits = _payload_hex(packet, 88)
        return AisBinaryMessage(
            mmsi=mmsi,
            seqno=get_bitfield(packet, 38, 2),
            dest_mmsi=get_bitfield(packet, 40, 30),
            retransmit=bool(get_bitfield(packet, 70, 1)),
            dac=get_bitfield(packet, 72, 10),
            fi=get_bitfield(packet, 82, 6),
            data=data, data_bits=nbits,
            repeat=repeat, raw=raw,
        )
    if msg_id == 9:
        return AisSarAircraftReport(
            mmsi=mmsi,
            altitude=get_bitfield(packet, 38, 12),
            speed_over_ground=float(get_bitfield(packet, 50, 10)),
            position_acc=get_bitfield(packet, 60, 1),
            longitude=get_bitfield_signed(packet, 61, 28) / 600000.0,
            latitude=get_bitfield_signed(packet, 89, 27) / 600000.0,
            course=get_bitfield(packet, 116, 12),
            timestamp=get_bitfield(packet, 128, 6),
            repeat=repeat,
            raw=raw,
        )
    if msg_id == 19:
        return AisExtendedClassBReport(
            mmsi=mmsi,
            speed_over_ground=get_bitfield(packet, 46, 10) / 10.0,
            position_acc=get_bitfield(packet, 56, 1),
            longitude=get_bitfield_signed(packet, 57, 28) / 600000.0,
            latitude=get_bitfield_signed(packet, 85, 27) / 600000.0,
            course=get_bitfield(packet, 112, 12),
            heading=get_bitfield(packet, 124, 9),
            timestamp=get_bitfield(packet, 133, 6),
            name=get_string(packet, 143, 20),
            ship_type=get_bitfield(packet, 263, 8),
            dim_to_bow=get_bitfield(packet, 271, 9),
            dim_to_stern=get_bitfield(packet, 280, 9),
            dim_to_port=get_bitfield(packet, 289, 6),
            dim_to_starboard=get_bitfield(packet, 295, 6),
            epfd_type=get_bitfield(packet, 301, 4),
            repeat=repeat,
            raw=raw,
        )
    if msg_id in (7, 13):
        # 1-4 (dest_mmsi, seqno) pairs; include only fully-present pairs
        acks = []
        bit = 40
        while bit + 32 <= len(packet) * 8 and len(acks) < 4:
            dest = get_bitfield(packet, bit, 30)
            if dest == 0:
                break
            acks.append((dest, get_bitfield(packet, bit + 30, 2)))
            bit += 32
        if not acks:
            return None
        return AisAcknowledge(mmsi=mmsi, acks=acks, msg_id=msg_id,
                              repeat=repeat, raw=raw)
    if msg_id == 10:
        return AisUtcInquiry(
            mmsi=mmsi, dest_mmsi=get_bitfield(packet, 40, 30),
            repeat=repeat, raw=raw,
        )
    if msg_id == 15:
        nbits = len(packet) * 8
        targets = []
        m1 = get_bitfield(packet, 40, 30)
        if m1:
            targets.append((m1, get_bitfield(packet, 70, 6),
                            get_bitfield(packet, 76, 12)))
            if nbits >= 108:
                t12 = get_bitfield(packet, 90, 6)
                if t12:
                    targets.append((m1, t12, get_bitfield(packet, 96, 12)))
        if nbits >= 158:
            m2 = get_bitfield(packet, 110, 30)
            if m2:
                targets.append((m2, get_bitfield(packet, 140, 6),
                                get_bitfield(packet, 146, 12)))
        if not targets:
            return None
        return AisInterrogation(mmsi=mmsi, targets=targets,
                                repeat=repeat, raw=raw)
    if msg_id == 16:
        nbits = len(packet) * 8
        assignments = [(get_bitfield(packet, 40, 30),
                        get_bitfield(packet, 70, 12),
                        get_bitfield(packet, 82, 10))]
        if nbits >= 144:
            m2 = get_bitfield(packet, 92, 30)
            if m2:
                assignments.append((m2, get_bitfield(packet, 122, 12),
                                    get_bitfield(packet, 134, 10)))
        return AisAssignmentCommand(mmsi=mmsi, assignments=assignments,
                                    repeat=repeat, raw=raw)
    if msg_id == 17:
        data, nbits = _payload_hex(packet, 80)
        return AisDgnssBroadcast(
            mmsi=mmsi,
            longitude=get_bitfield_signed(packet, 40, 18) / 600.0,
            latitude=get_bitfield_signed(packet, 58, 17) / 600.0,
            data=data, data_bits=nbits,
            repeat=repeat, raw=raw,
        )
    if msg_id == 20:
        reservations = []
        bit = 40
        while bit + 30 <= len(packet) * 8 and len(reservations) < 4:
            offs = get_bitfield(packet, bit, 12)
            if offs == 0:
                break
            reservations.append((offs,
                                 get_bitfield(packet, bit + 12, 4),
                                 get_bitfield(packet, bit + 16, 3),
                                 get_bitfield(packet, bit + 19, 11)))
            bit += 30
        if not reservations:
            return None
        return AisDataLinkManagement(mmsi=mmsi, reservations=reservations,
                                     repeat=repeat, raw=raw)
    if msg_id == 22:
        addressed = bool(get_bitfield(packet, 139, 1))
        m = AisChannelManagement(
            mmsi=mmsi,
            channel_a=get_bitfield(packet, 40, 12),
            channel_b=get_bitfield(packet, 52, 12),
            txrx_mode=get_bitfield(packet, 64, 4),
            power=get_bitfield(packet, 68, 1),
            addressed=addressed,
            band_a=get_bitfield(packet, 140, 1)
            if len(packet) * 8 > 140 else 0,
            band_b=get_bitfield(packet, 141, 1)
            if len(packet) * 8 > 141 else 0,
            zone_size=get_bitfield(packet, 142, 3)
            if len(packet) * 8 >= 145 else 0,
            repeat=repeat, raw=raw,
        )
        if addressed:
            m.dest1 = get_bitfield(packet, 69, 30)
            m.dest2 = get_bitfield(packet, 104, 30)
        else:
            m.ne_lon = get_bitfield_signed(packet, 69, 18) / 600.0
            m.ne_lat = get_bitfield_signed(packet, 87, 17) / 600.0
            m.sw_lon = get_bitfield_signed(packet, 104, 18) / 600.0
            m.sw_lat = get_bitfield_signed(packet, 122, 17) / 600.0
        return m
    if msg_id == 23:
        return AisGroupAssignment(
            mmsi=mmsi,
            ne_lon=get_bitfield_signed(packet, 40, 18) / 600.0,
            ne_lat=get_bitfield_signed(packet, 58, 17) / 600.0,
            sw_lon=get_bitfield_signed(packet, 75, 18) / 600.0,
            sw_lat=get_bitfield_signed(packet, 93, 17) / 600.0,
            station_type=get_bitfield(packet, 110, 4),
            ship_type=get_bitfield(packet, 114, 8),
            txrx_mode=get_bitfield(packet, 144, 2),
            interval=get_bitfield(packet, 146, 4),
            quiet_time=get_bitfield(packet, 150, 4),
            repeat=repeat, raw=raw,
        )
    if msg_id in (25, 26):
        nbits = len(packet) * 8
        addressed = bool(get_bitfield(packet, 38, 1))
        structured = bool(get_bitfield(packet, 39, 1))
        bit = 40
        dest = app = None
        if addressed:
            if nbits < bit + 30:
                return None
            dest = get_bitfield(packet, bit, 30)
            bit += 30
        if structured:
            if nbits < bit + 16:
                return None
            app = get_bitfield(packet, bit, 16)
            bit += 16
        radio = None
        end = nbits
        if msg_id == 26:
            # the comm state is the message's LAST 20 bits (byte-granular
            # transport: anchored at the de-stuffed packet's end)
            if nbits < bit + 20:
                return None
            end = nbits - 20
            radio = get_bitfield(packet, end, 20)
        data, data_bits = _payload_hex(packet, bit, end)
        return AisSlotBinaryMessage(
            mmsi=mmsi, data=data, data_bits=data_bits, msg_id=msg_id,
            addressed=addressed, structured=structured,
            dest_mmsi=dest, app_id=app, radio_status=radio,
            repeat=repeat, raw=raw,
        )
    if msg_id == 27:
        return AisLongRangePositionReport(
            mmsi=mmsi,
            position_acc=get_bitfield(packet, 38, 1),
            raim=bool(get_bitfield(packet, 39, 1)),
            nav_stat=get_bitfield(packet, 40, 4),
            longitude=get_bitfield_signed(packet, 44, 18) / 600.0,
            latitude=get_bitfield_signed(packet, 62, 17) / 600.0,
            speed_over_ground=float(get_bitfield(packet, 79, 6)),
            course=get_bitfield(packet, 85, 9),
            repeat=repeat,
            raw=raw,
        )
    return None


class AisDemodulator:
    """Raw HDLC packet receiver; feed 48 kHz int16 PCM via :meth:`on_pcm`.

    Emits (packet_bytes, fcs_valid) tuples; the reference only delivers
    CRC-valid packets to the callback — invalid ones bump a counter
    (``ais_demod.c:198-205``), mirrored by :attr:`crc_rejects`.
    """

    _SEARCH, _RECEIVING = 0, 1

    def __init__(self, vectorized: bool = True, native: bool = True):
        # vectorized RECEIVING path (exact scalar equivalent; False keeps
        # the per-sample reference loop)
        self._vectorized = vectorized
        self._search_window = 512
        # native C++ FSM (native/tslstream.cc tsl_ais_*), built at first use
        # (a failed build raises); native=False keeps the numpy path
        self._nat = AisNative() if native else None
        self.state = self._SEARCH
        self.preambles = [0] * DECIMATION
        self.prior_sample = [0] * DECIMATION
        self.next_field = 0
        self.sample_skip = 0
        self._crc_rejects = 0
        self._rx_reset()
        self.packets: list[bytes] = []
        # scan() streaming carry (see PocsagDecoder)
        self._scan_tail = np.zeros(0, np.int16)
        self._scan_prefed = 0
        self._scan_want = 0
        self._scan_ever = False
        self._in_scan = False

    @property
    def crc_rejects(self) -> int:
        if self._nat is not None:
            return self._nat.crc_rejects
        return self._crc_rejects

    def _in_search(self) -> bool:
        if self._nat is not None:
            return self._nat.in_search
        return self.state == self._SEARCH

    @property
    def supports_gating(self) -> bool:
        """See PocsagDecoder.supports_gating."""
        return self._nat is not None

    @property
    def in_search(self) -> bool:
        """True while hunting the preamble (no packet in flight)."""
        return self._in_search()

    def notify_gap(self):
        """A sync-free span was skipped upstream (device-prefilter egress
        gating): reset the preamble detectors."""
        self._reset_detect_any()

    def _reset_detect_any(self):
        if self._nat is not None:
            self._nat.detect_reset()
        else:
            self._detect_reset()

    def _rx_reset(self):
        self.packet = bytearray(MAX_PACKET_BITS // 8 * 5)
        self.raw_shr = 0
        self.current_bit = 0
        self.nr_ones = 0
        self.last_sample = 0

    def _detect_reset(self):
        self.preambles = [0] * DECIMATION
        self.prior_sample = [0] * DECIMATION
        self.next_field = 0

    def _detect_sample(self, sample: int):
        s = 1 if sample > 0 else 0
        nf = self.next_field
        last = self.prior_sample[nf]
        self.prior_sample[nf] = s
        self.preambles[nf] = (
            (self.preambles[nf] << 1) | (0 if (last ^ s) else 1)
        ) & 0xFFFFFFFF
        nr_match = sum(
            1
            for p in self.preambles
            if bin(p ^ PREAMBLE_PATTERN).count("1") <= 2
        )
        if nr_match >= 3:
            self.state = self._RECEIVING
            self.sample_skip = 2
            self._rx_reset()
            self.last_sample = self.prior_sample[nf]
        self.next_field = (nf + 1) % DECIMATION

    def _rx_finalize(self):
        nbytes = self.current_bit // 8
        if nbytes >= 4:
            body = bytes(self.packet[: nbytes - 2])
            rx_crc = self.packet[nbytes - 2] | (self.packet[nbytes - 1] << 8)
            if crc16_x25(body) == rx_crc:
                self.packets.append(body)
            else:
                self._crc_rejects += 1
        self.state = self._SEARCH
        self.sample_skip = 0
        self._detect_reset()

    def _rx_sample(self, sample: int):
        raw = 1 if sample > 0 else 0
        bit = 0 if (self.last_sample ^ raw) else 1
        self.raw_shr = ((self.raw_shr << 1) | bit) & 0xFF
        self.last_sample = raw
        if self.nr_ones < 5:
            self.packet[self.current_bit // 8] |= bit << (self.current_bit % 8)
            self.current_bit += 1
        self.nr_ones = 0 if bit == 0 else self.nr_ones + 1

        if self.raw_shr == END_FLAG or self.current_bit == MAX_PACKET_BITS:
            self._rx_finalize()

    def _search_vec(self, pcm, i: int, n: int) -> int:
        """Vectorized SEARCH: evolve all five phase-interleaved preamble
        registers over the block and find the first sample where >= 3 of 5
        match within hamming 2 (exact equivalent of the ``_detect_sample``
        loop; fuzz-tested). Returns the new sample index.

        Works one bounded window at a time: after a packet ends the FSM
        re-enters SEARCH mid-block, and re-scanning the whole remainder per
        packet would be quadratic in dense traffic. The window grows while
        nothing triggers (noise: amortize numpy overhead) and shrinks back
        on a trigger (dense traffic: the next preamble is near). Window
        composition is exact thanks to the end-of-window materialization."""
        n = min(n, i + self._search_window)
        L = n - i
        s = (pcm[i:n] > 0).astype(np.uint8)
        nf = self.next_field
        D = DECIMATION

        # The register freshly updated at sample j is the 32 NRZI bits at
        # stride D ending at j; the 5 most recent samples update the 5
        # distinct phases exactly once each, so the FSM's nr_match at j is
        # a 5-wide moving sum of a single per-sample match stream. One
        # 32-shift pass replaces the per-phase loops.
        #
        # Virtual pre-block NRZI stream reconstructed from the carried
        # registers: at virtual sample -(d+1), phase (nf-1-d) mod D, bit
        # (preambles[phase] >> (d // D)) & 1.
        d_idx = np.arange(32 * D)
        pre = np.empty(32 * D, np.uint8)
        ph = (nf - 1 - d_idx) % D
        pre[::-1] = (np.asarray(self.preambles, np.uint64)[ph]
                     >> (d_idx // D).astype(np.uint64)).astype(np.uint8) & 1
        # NRZI bits of the block: prev raw at j-D (prior_sample for j < D)
        prev = np.empty(L, np.uint8)
        pl = min(D, L)
        prev[:pl] = [self.prior_sample[(nf + j) % D] for j in range(pl)]
        prev[D:] = s[:-D] if L > D else prev[D:]
        bits = (1 - (s ^ prev)).astype(np.uint32)
        full = np.concatenate([pre, bits])
        base = 32 * D
        # registers for positions j in [-4, L): 4 virtual positions so the
        # moving sum at j < 4 sees the carried phases' registers
        g = 4
        w = np.zeros(L + g, np.uint32)
        for k in range(32):
            lo = base - g - k * D
            w |= full[lo : lo + L + g] << np.uint32(k)
        v = w ^ np.uint32(PREAMBLE_PATTERN)
        v = v - ((v >> 1) & np.uint32(0x55555555))
        v = (v & np.uint32(0x33333333)) + ((v >> 2) & np.uint32(0x33333333))
        v = (v + (v >> 4)) & np.uint32(0x0F0F0F0F)
        match = (((v * np.uint32(0x01010101)) >> np.uint32(24)) <= 2)
        csum = np.cumsum(np.concatenate([[0], match.astype(np.int32)]))
        nr_match = csum[g + 1 + np.arange(L)] - csum[np.arange(L)]

        trig = np.flatnonzero(nr_match >= 3)
        if trig.size == 0:
            # no trigger: materialize the exact end-of-block detector state
            # (the last min(L, D) samples hold each phase's final register)
            for d in range(min(L, D)):
                j = L - 1 - d
                q = (nf + j) % D
                self.preambles[q] = int(w[g + j])
                self.prior_sample[q] = int(s[j])
            self.next_field = (nf + L) % D
            self._search_window = min(self._search_window * 4, 1 << 20)
            return n
        j = int(trig[0])
        # trigger: replicate _detect_sample's transition at sample j. The
        # detector arrays are left stale — every path back to SEARCH goes
        # through _rx_finalize -> _detect_reset, so they are never read.
        self.state = self._RECEIVING
        self.sample_skip = 2
        self._rx_reset()
        self.last_sample = int(s[j])
        self.next_field = (nf + j + 1) % DECIMATION
        self._search_window = 512
        return i + j + 1

    def _rx_vec(self, pcm, i: int, n: int) -> int:
        """Vectorized RECEIVING: NRZI decode, HDLC destuff, flag hunt and
        packet fill over the whole remaining block (exact equivalent of the
        per-sample ``_rx_sample`` loop; fuzz-tested). Returns the new sample
        index.

        Bounded to a window comfortably above one max-length packet so a
        packet ending early in a large block doesn't pay for the whole
        remainder (windows compose exactly via the carried registers)."""
        n = min(n, i + 2560)
        s0 = self.sample_skip
        k0 = (-s0) % DECIMATION
        if i + k0 >= n:
            self.sample_skip = s0 + (n - i)
            return n
        raws = (pcm[i + k0 : n : DECIMATION] > 0).astype(np.uint8)
        m = raws.shape[0]
        prev = np.empty(m, np.uint8)
        prev[0] = self.last_sample
        prev[1:] = raws[:-1]
        bits = (1 - (raws ^ prev)).astype(np.uint8)

        # end-flag positions: decoded shift register == 0x7E, i.e. the 8
        # decoded bits ending here are 0,1,1,1,1,1,1,0 (with raw_shr carry)
        hist = np.array([(self.raw_shr >> k) & 1 for k in range(6, -1, -1)],
                        np.uint8)
        full = np.concatenate([hist, bits])
        ok = ((full[7:] == 0) & (full[6:-1] == 1) & (full[5:-2] == 1)
              & (full[4:-3] == 1) & (full[3:-4] == 1) & (full[2:-5] == 1)
              & (full[1:-6] == 1) & (full[:-7] == 0))

        # destuff mask: a bit is appended iff < 5 consecutive ones precede it
        pre = min(self.nr_ones, 5)
        vb = np.concatenate([np.ones(pre, np.uint8), bits])
        pos = np.arange(vb.shape[0])
        lz = np.maximum.accumulate(np.where(vb == 0, pos, -1))
        runs = np.where(vb == 1, pos - lz, 0)
        before = np.empty(m, np.int64)
        if pre:
            before[:] = runs[pre - 1 : pre - 1 + m]
        else:
            before[0] = 0
            before[1:] = runs[:m - 1]
        appended = before < 5
        cum = np.cumsum(appended)

        # stop at the first flag or at the appended bit that fills the packet
        stops = np.flatnonzero(ok | (appended & (cum + self.current_bit
                                                 == MAX_PACKET_BITS)))
        j_end = int(stops[0]) if stops.size else m - 1

        app = bits[: j_end + 1][appended[: j_end + 1]]
        count = app.shape[0]
        if count:
            cb0 = self.current_bit
            buf = np.unpackbits(np.frombuffer(bytes(self.packet), np.uint8),
                                bitorder="little")
            buf[cb0 : cb0 + count] = app
            self.packet[:] = np.packbits(buf, bitorder="little").tobytes()
            self.current_bit = cb0 + count

        if stops.size:
            # replicate the scalar registers at the stop sample, then reuse
            # the shared finalize (state -> SEARCH, sample_skip = 0)
            e = 7 + j_end
            self.raw_shr = int(np.packbits(full[e - 7 : e + 1])[0])
            self.last_sample = int(raws[j_end])
            self._rx_finalize()
            return i + k0 + j_end * DECIMATION + 1

        # block exhausted: advance the carries exactly as the loop would
        trail = int(runs[-1]) if vb[-1] == 1 else 0
        # a ones-run covering every bit extends the true carried count
        self.nr_ones = self.nr_ones + m if trail >= m else trail
        self.raw_shr = int(np.packbits(full[-8:])[0])
        self.last_sample = int(raws[-1])
        self.sample_skip = s0 + (n - i)
        return n

    def scan(self, pcm) -> list[bytes]:
        """Batch decode with a vectorized preamble fast-forward.

        Packet-exact vs :meth:`on_pcm`: the preamble trigger needs >=3 of 5
        phase registers within hamming 2 of 0x5555557E; a numpy prefilter
        marks every sample whose freshly-updated register is within hamming
        2 (a strict superset). The unmodified FSM runs only from 40*5
        samples before each candidate (registers and NRZI history refill).

        Streaming-safe: the last ``lookback`` samples are always carried as
        prefilter context with the FSM-fed prefix tracked (see
        PocsagDecoder.scan). Do not interleave scan() and on_pcm() on the
        same instance.
        """
        pcm = np.asarray(pcm, dtype=np.int16)
        if self._nat is not None:
            # the native FSM outruns the numpy prefilter by ~10x, so scan()
            # is a straight delegate (all samples FSM-fed; no carry needed)
            new = self._nat.on_pcm(pcm)
            self.packets.extend(new)
            return new
        start_msg = len(self.packets)
        self._scan_ever = True
        self._in_scan = True
        tail = self._scan_tail
        prefed = self._scan_prefed
        feed_until = prefed + self._scan_want
        if tail.size:
            pcm = np.concatenate([tail, pcm])
        self._scan_tail = np.zeros(0, np.int16)
        self._scan_prefed = 0
        self._scan_want = 0
        n = pcm.shape[0]

        s = (pcm > 0).astype(np.uint32)
        nrzi = np.zeros(n, dtype=np.uint32)
        nrzi[DECIMATION:] = 1 - (s[DECIMATION:] ^ s[:-DECIMATION])
        pad = 31 * DECIMATION
        bp = np.concatenate([np.zeros(pad, np.uint32), nrzi])
        # the trigger needs >=3 of 5 phase registers matching; their update
        # instants are 3 distinct samples within a 5-sample window. A
        # stride-2 grid covers 3 of any 5 consecutive positions, so at least
        # one match instant always lands on a probe (stride 3 could miss:
        # matches at {1,2,4} avoid grid {0,3}). Superset preserved, half the
        # work.
        stride = 2
        pos = np.arange(0, n, stride)
        w = np.zeros(pos.shape[0], dtype=np.uint32)
        for k in range(32):
            s0 = pad - k * DECIMATION
            w |= bp[s0 : s0 + n : stride] << np.uint32(k)
        v = w ^ np.uint32(PREAMBLE_PATTERN)
        v = v - ((v >> 1) & np.uint32(0x55555555))
        v = (v & np.uint32(0x33333333)) + ((v >> 2) & np.uint32(0x33333333))
        v = (v + (v >> 4)) & np.uint32(0x0F0F0F0F)
        pc = (v * np.uint32(0x01010101)) >> np.uint32(24)
        cand_idx = pos[pc <= 2]

        lookback = 40 * DECIMATION
        chunk = 1280 * DECIMATION + 512  # max packet + margin

        i = prefed
        ci = 0
        fed_end = prefed
        want_end = feed_until
        while i < n:
            if not self._in_search():
                self.on_pcm(pcm[i : i + chunk])
                i += chunk
                fed_end = min(i, n)
                continue
            if i < feed_until:
                # finish the contiguous margin owed from the previous block
                end = min(n, feed_until)
                self.on_pcm(pcm[i:end])
                i = end
                fed_end = end
                continue
            while ci < len(cand_idx) and cand_idx[ci] < i:
                ci += 1
            if ci >= len(cand_idx):
                break
            c = int(cand_idx[ci])
            start = max(i, c - lookback)
            if start > i:
                self._reset_detect_any()  # zero registers cannot match
                i = start
            end = min(n, c + 8 * DECIMATION)
            self.on_pcm(pcm[i:end])
            i = end
            fed_end = end
            want_end = max(want_end, c + 8 * DECIMATION)
        if self._in_search():
            keep_start = max(0, n - lookback)
            if fed_end < keep_start:
                self._reset_detect_any()
            else:
                self._scan_prefed = fed_end - keep_start
                self._scan_want = max(0, want_end - n)
            self._scan_tail = pcm[keep_start:].copy()
        self._in_scan = False
        return self.packets[start_msg:]

    def on_pcm(self, pcm) -> list[bytes]:
        if self._scan_ever and not self._in_scan:
            raise RuntimeError(
                "do not interleave on_pcm() with scan() on the same "
                "decoder instance (scan carries prefilter state)")
        pcm = np.asarray(pcm, dtype=np.int16)
        if self._nat is not None:
            new = self._nat.on_pcm(pcm)
            self.packets.extend(new)
            return new
        start = len(self.packets)
        i = 0
        n = pcm.shape[0]
        while i < n:
            if self.state == self._SEARCH:
                if self._vectorized:
                    i = self._search_vec(pcm, i, n)
                    continue
                while i < n:
                    self._detect_sample(int(pcm[i]))
                    i += 1
                    if self.state == self._RECEIVING:
                        break
            else:
                if self._vectorized:
                    i = self._rx_vec(pcm, i, n)
                    continue
                while i < n:
                    skip = self.sample_skip
                    self.sample_skip += 1
                    if skip % DECIMATION == 0:
                        self._rx_sample(int(pcm[i]))
                        if self.state == self._SEARCH:
                            i += 1
                            break
                    i += 1
        return self.packets[start:]


def nmea_aivdm(packet: bytes, channel: str = "A",
               seq: int | None = None,
               max_payload_chars: int = 60) -> list:
    """Standard NMEA 0183 ``!AIVDM`` sentence(s) for a de-stuffed AIS
    packet: 6-bit armored payload, fill-bit count, XOR checksum, and
    multi-sentence splitting for long payloads (IEC 61162-1). This is
    the interop surface downstream AIS consumers (gpsd, OpenCPN, AIS
    aggregators) ingest — the reference emits only its own JSON."""
    nbits = len(packet) * 8
    chars = []
    for k in range(0, nbits, 6):
        take = min(6, nbits - k)
        v = get_bitfield(packet, k, take) << (6 - take)
        chars.append(chr(v + 48 if v <= 39 else v + 56))
    fill = (6 - nbits % 6) % 6
    payload = "".join(chars)
    groups = [payload[i:i + max_payload_chars]
              for i in range(0, len(payload), max_payload_chars)] or [""]
    total = len(groups)
    # single sentences carry an empty sequential-id field by convention
    seq_s = "" if total == 1 else str((0 if seq is None else seq) % 10)
    out = []
    for num, g in enumerate(groups, 1):
        body = (f"AIVDM,{total},{num},{seq_s},{channel},{g},"
                f"{fill if num == total else 0}")
        ck = 0
        for c in body:
            ck ^= ord(c)
        out.append(f"!{body}*{ck:02X}")
    return out


def aivdm_channel_for_freq(freq_hz) -> str:
    """VHF channel letter for an AIS carrier: 161.975 MHz (ch 87B) = 'A',
    162.025 MHz (ch 88B) = 'B'; anything else reports 'A'."""
    if freq_hz is not None and abs(freq_hz - 162_025_000) < 5_000:
        return "B"
    return "A"


class NmeaEmitter:
    """Stateful AIVDM writer for the CLIs: builds sentences via
    :func:`nmea_aivdm`, rotates the sequential id across multi-sentence
    groups, frames with CRLF and flushes per packet. ``channel`` is a
    letter, or a callable(center_freq_hz) -> letter for multi-channel
    pipelines (see :func:`aivdm_channel_for_freq`)."""

    def __init__(self, fobj, channel="A"):
        self._fobj = fobj
        self._channel = channel
        self._seq = 0

    def __call__(self, packet: bytes, freq_hz=None):
        ch = (self._channel(freq_hz) if callable(self._channel)
              else self._channel)
        sents = nmea_aivdm(packet, channel=ch, seq=self._seq)
        if len(sents) > 1:
            self._seq = (self._seq + 1) % 10
        for s in sents:
            self._fobj.write(s + "\r\n")
        self._fobj.flush()


def nmea_dearmor(payload: str, fill: int = 0) -> bytes:
    """Inverse of the AIVDM payload armor (test/interop helper): 6-bit
    chars back to packet bytes, dropping ``fill`` trailing pad bits."""
    nbits = 6 * len(payload) - fill
    v = 0
    for c in payload:
        x = ord(c) - 48
        if x > 40:
            x -= 8
        v = (v << 6) | x
    v >>= (6 * len(payload) - nbits)
    v <<= (-nbits) % 8
    return v.to_bytes((nbits + 7) // 8, "big")


class AisDecoder:
    """Full AIS receive chain: demod + field decode (48 kHz PCM in).

    ``packet_hook`` (optional) fires with every CRC-valid de-stuffed
    packet's bytes before field decode — the tap NMEA re-emission rides
    (see :func:`nmea_aivdm`)."""

    def __init__(self, vectorized: bool = True, native: bool = True,
                 packet_hook=None):
        self.demod = AisDemodulator(vectorized=vectorized, native=native)
        self.messages = []
        self.packet_hook = packet_hook

    @property
    def _nat(self):
        """The demodulator's native FSM (None on the numpy tier), as the
        POCSAG and FLEX decoders expose theirs."""
        return self.demod._nat

    @property
    def crc_rejects(self) -> int:
        return self.demod.crc_rejects

    @property
    def supports_gating(self) -> bool:
        return self.demod.supports_gating

    @property
    def in_search(self) -> bool:
        return self.demod.in_search

    def notify_gap(self):
        self.demod.notify_gap()

    def on_pcm(self, pcm):
        start = len(self.messages)
        for packet in self.demod.on_pcm(pcm):
            if self.packet_hook is not None:
                self.packet_hook(packet)
            msg = decode_fields(packet)
            if msg is not None:
                self.messages.append(msg)
        return self.messages[start:]

    def scan(self, pcm):
        """Batch decode via the demodulator's vectorized preamble scan."""
        start = len(self.messages)
        for packet in self.demod.scan(pcm):
            if self.packet_hook is not None:
                self.packet_hook(packet)
            msg = decode_fields(packet)
            if msg is not None:
                self.messages.append(msg)
        return self.messages[start:]
