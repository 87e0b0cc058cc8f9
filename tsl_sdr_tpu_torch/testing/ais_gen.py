"""AIS transmission generator (HDLC frame + NRZI baseband at 48 kHz).

Builds packets in the decoder's byte/field convention (MSB-first bitfields
over the byte array; bytes transmitted LSB-first, as the receiver stores
incoming bits LSB-first per byte — ``ais_demod.c:181``), appends the
CRC-16/X.25, HDLC-stuffs, frames with 0x7E flags, prepends the 24-bit
alternating preamble, NRZI-encodes (decoded bit 1 == no level transition)
and expands 5 samples/bit.

The port's copy of ``tsl_sdr_tpu/testing/ais_gen.py`` on the port's own
AIS decoder constants.
"""

from __future__ import annotations

import numpy as np

from tsl_sdr_tpu_torch.models.ais import DECIMATION, crc16_x25


def set_bitfield(packet: bytearray, offset: int, length: int, value: int):
    """MSB-first field packing — inverse of ais.get_bitfield."""
    value &= (1 << length) - 1
    for k in range(length):
        bit = (value >> (length - 1 - k)) & 1
        pos = offset + k
        if bit:
            packet[pos // 8] |= 0x80 >> (pos % 8)
        else:
            packet[pos // 8] &= ~(0x80 >> (pos % 8)) & 0xFF


def set_string(packet: bytearray, offset: int, nr_chars: int, text: str):
    for i in range(nr_chars):
        c = ord(text[i]) if i < len(text) else ord("@")  # '@' decodes to '\0'-ish
        v = c - 0x40 if c >= 0x40 else c
        set_bitfield(packet, offset + 6 * i, 6, v)


def make_position_report(
    mmsi: int,
    *,
    msg_id: int = 1,
    repeat: int = 0,
    nav_stat: int = 0,
    rate_of_turn: int = 0,
    speed_over_ground: float = 0.0,
    position_acc: int = 0,
    longitude: float = 0.0,
    latitude: float = 0.0,
    course: int = 0,
    heading: int = 0,
    timestamp: int = 0,
) -> bytes:
    p = bytearray(21)  # 168 bits
    set_bitfield(p, 0, 6, msg_id)
    set_bitfield(p, 6, 2, repeat)
    set_bitfield(p, 8, 30, mmsi)
    set_bitfield(p, 38, 4, nav_stat)
    set_bitfield(p, 42, 8, rate_of_turn & 0xFF)
    set_bitfield(p, 50, 10, int(round(speed_over_ground * 10)))
    set_bitfield(p, 60, 1, position_acc)
    set_bitfield(p, 61, 28, int(round(longitude * 600000)) & ((1 << 28) - 1))
    set_bitfield(p, 89, 27, int(round(latitude * 600000)) & ((1 << 27) - 1))
    set_bitfield(p, 116, 12, course)
    set_bitfield(p, 128, 9, heading)
    set_bitfield(p, 137, 6, timestamp)
    return bytes(p)


def make_class_b_position_report(
    mmsi: int,
    *,
    repeat: int = 0,
    speed_over_ground: float = 0.0,
    position_acc: int = 0,
    longitude: float = 0.0,
    latitude: float = 0.0,
    course: int = 0,
    heading: int = 0,
    timestamp: int = 0,
) -> bytes:
    """Type 18 Class B position report (beyond-reference extension)."""
    p = bytearray(21)  # 168 bits
    set_bitfield(p, 0, 6, 18)
    set_bitfield(p, 6, 2, repeat)
    set_bitfield(p, 8, 30, mmsi)
    set_bitfield(p, 46, 10, int(round(speed_over_ground * 10)))
    set_bitfield(p, 56, 1, position_acc)
    set_bitfield(p, 57, 28, int(round(longitude * 600000)) & ((1 << 28) - 1))
    set_bitfield(p, 85, 27, int(round(latitude * 600000)) & ((1 << 27) - 1))
    set_bitfield(p, 112, 12, course)
    set_bitfield(p, 124, 9, heading)
    set_bitfield(p, 133, 6, timestamp)
    return bytes(p)


def make_sar_aircraft_report(
    mmsi: int,
    *,
    repeat: int = 0,
    altitude: int = 0,
    speed_over_ground: float = 0.0,
    position_acc: int = 0,
    longitude: float = 0.0,
    latitude: float = 0.0,
    course: int = 0,
    timestamp: int = 0,
) -> bytes:
    """Type 9 SAR aircraft position report (beyond-reference extension)."""
    p = bytearray(21)  # 168 bits
    set_bitfield(p, 0, 6, 9)
    set_bitfield(p, 6, 2, repeat)
    set_bitfield(p, 8, 30, mmsi)
    set_bitfield(p, 38, 12, altitude)
    set_bitfield(p, 50, 10, int(round(speed_over_ground)))
    set_bitfield(p, 60, 1, position_acc)
    set_bitfield(p, 61, 28, int(round(longitude * 600000)) & ((1 << 28) - 1))
    set_bitfield(p, 89, 27, int(round(latitude * 600000)) & ((1 << 27) - 1))
    set_bitfield(p, 116, 12, course)
    set_bitfield(p, 128, 6, timestamp)
    return bytes(p)


def make_extended_class_b_report(
    mmsi: int,
    *,
    repeat: int = 0,
    speed_over_ground: float = 0.0,
    position_acc: int = 0,
    longitude: float = 0.0,
    latitude: float = 0.0,
    course: int = 0,
    heading: int = 0,
    timestamp: int = 0,
    name: str = "",
    ship_type: int = 0,
    dims=(0, 0, 0, 0),
    epfd_type: int = 0,
) -> bytes:
    """Type 19 extended Class B report (beyond-reference extension)."""
    p = bytearray(39)  # 312 bits
    set_bitfield(p, 0, 6, 19)
    set_bitfield(p, 6, 2, repeat)
    set_bitfield(p, 8, 30, mmsi)
    set_bitfield(p, 46, 10, int(round(speed_over_ground * 10)))
    set_bitfield(p, 56, 1, position_acc)
    set_bitfield(p, 57, 28, int(round(longitude * 600000)) & ((1 << 28) - 1))
    set_bitfield(p, 85, 27, int(round(latitude * 600000)) & ((1 << 27) - 1))
    set_bitfield(p, 112, 12, course)
    set_bitfield(p, 124, 9, heading)
    set_bitfield(p, 133, 6, timestamp)
    set_string(p, 143, 20, name)
    set_bitfield(p, 263, 8, ship_type)
    set_bitfield(p, 271, 9, dims[0])
    set_bitfield(p, 280, 9, dims[1])
    set_bitfield(p, 289, 6, dims[2])
    set_bitfield(p, 295, 6, dims[3])
    set_bitfield(p, 301, 4, epfd_type)
    return bytes(p)


def make_static_data_report(
    mmsi: int,
    *,
    part: str = "A",
    ship_name: str = "",
    ship_type: int = 0,
    vendor_id: str = "",
    callsign: str = "",
    dims=(0, 0, 0, 0),
) -> bytes:
    """Type 24 Class B static data report (beyond-reference extension)."""
    p = bytearray(21 if part == "A" else 21)  # 160/168 bits, pad to bytes
    set_bitfield(p, 0, 6, 24)
    set_bitfield(p, 8, 30, mmsi)
    if part == "A":
        set_bitfield(p, 38, 2, 0)
        set_string(p, 40, 20, ship_name)
    else:
        set_bitfield(p, 38, 2, 1)
        set_bitfield(p, 40, 8, ship_type)
        set_string(p, 48, 7, vendor_id)
        set_string(p, 90, 7, callsign)
        set_bitfield(p, 132, 9, dims[0])
        set_bitfield(p, 141, 9, dims[1])
        set_bitfield(p, 150, 6, dims[2])
        set_bitfield(p, 156, 6, dims[3])
    return bytes(p)


def make_base_station_report(
    mmsi: int, *, year=2026, month=8, day=16, hour=12, minute=34, second=56,
    longitude=0.0, latitude=0.0, epfd_type=1,
) -> bytes:
    p = bytearray(21)
    set_bitfield(p, 0, 6, 4)
    set_bitfield(p, 8, 30, mmsi)
    set_bitfield(p, 38, 14, year)
    set_bitfield(p, 52, 4, month)
    set_bitfield(p, 56, 5, day)
    set_bitfield(p, 61, 5, hour)
    set_bitfield(p, 66, 6, minute)
    set_bitfield(p, 72, 6, second)
    set_bitfield(p, 79, 28, int(round(longitude * 600000)) & ((1 << 28) - 1))
    set_bitfield(p, 107, 27, int(round(latitude * 600000)) & ((1 << 27) - 1))
    set_bitfield(p, 134, 4, epfd_type)
    return bytes(p)


def make_static_voyage(
    mmsi: int, *, imo=9074729, callsign="WDA1234", ship_name="EVER GIVEN",
    ship_type=70, dims=(100, 300, 20, 30), fix_type=1,
    eta=(8, 20, 6, 30), draught=12.5, destination="ROTTERDAM",
) -> bytes:
    p = bytearray(53)  # 424 bits
    set_bitfield(p, 0, 6, 5)
    set_bitfield(p, 8, 30, mmsi)
    set_bitfield(p, 38, 2, 0)
    set_bitfield(p, 40, 30, imo)
    set_string(p, 70, 7, callsign)
    set_string(p, 112, 20, ship_name)
    set_bitfield(p, 232, 8, ship_type)
    set_bitfield(p, 240, 9, dims[0])
    set_bitfield(p, 249, 9, dims[1])
    set_bitfield(p, 258, 6, dims[2])
    set_bitfield(p, 264, 6, dims[3])
    set_bitfield(p, 270, 4, fix_type)
    set_bitfield(p, 274, 4, eta[0])
    set_bitfield(p, 278, 5, eta[1])
    set_bitfield(p, 283, 5, eta[2])
    set_bitfield(p, 288, 6, eta[3])
    set_bitfield(p, 294, 8, int(round(draught * 10)))
    set_string(p, 302, 20, destination)
    return bytes(p)


def make_aid_to_navigation(
    mmsi: int, *, aid_type=1, name="SAFE WATER", longitude=0.0, latitude=0.0,
    dims=(2, 2, 2, 2), epfd_type=1, timestamp=60, off_position=False,
    virtual_aid=False,
) -> bytes:
    """Type 21 (aid-to-navigation), ITU-R M.1371-5 table 74 (272 bits)."""
    p = bytearray(34)
    set_bitfield(p, 0, 6, 21)
    set_bitfield(p, 8, 30, mmsi)
    set_bitfield(p, 38, 5, aid_type)
    set_string(p, 43, 20, name)
    set_bitfield(p, 164, 28, int(round(longitude * 600000)) & ((1 << 28) - 1))
    set_bitfield(p, 192, 27, int(round(latitude * 600000)) & ((1 << 27) - 1))
    set_bitfield(p, 219, 9, dims[0])
    set_bitfield(p, 228, 9, dims[1])
    set_bitfield(p, 237, 6, dims[2])
    set_bitfield(p, 243, 6, dims[3])
    set_bitfield(p, 249, 4, epfd_type)
    set_bitfield(p, 253, 6, timestamp)
    set_bitfield(p, 259, 1, 1 if off_position else 0)
    set_bitfield(p, 269, 1, 1 if virtual_aid else 0)
    return bytes(p)


def make_long_range_position(
    mmsi: int, *, nav_stat=0, longitude=0.0, latitude=0.0,
    speed_over_ground=0, course=0, raim=False,
) -> bytes:
    """Type 27 (long-range position), ITU-R M.1371-5 table 96 (96 bits)."""
    p = bytearray(12)
    set_bitfield(p, 0, 6, 27)
    set_bitfield(p, 8, 30, mmsi)
    set_bitfield(p, 39, 1, 1 if raim else 0)
    set_bitfield(p, 40, 4, nav_stat)
    set_bitfield(p, 44, 18, int(round(longitude * 600)) & ((1 << 18) - 1))
    set_bitfield(p, 62, 17, int(round(latitude * 600)) & ((1 << 17) - 1))
    set_bitfield(p, 79, 6, int(round(speed_over_ground)))
    set_bitfield(p, 85, 9, course)
    return bytes(p)


def make_safety_broadcast(mmsi: int, text: str) -> bytes:
    """Type 14 (safety-related broadcast), ITU-R M.1371-5 § M.3.12:
    header + spare, then 6-bit text to the end of the payload."""
    nbits = 40 + 6 * len(text)
    p = bytearray((nbits + 7) // 8)
    set_bitfield(p, 0, 6, 14)
    set_bitfield(p, 8, 30, mmsi)
    set_string(p, 40, len(text), text)
    return bytes(p)


def make_addressed_safety(
    mmsi: int, dest_mmsi: int, text: str, *, seqno=0, retransmit=False,
) -> bytes:
    """Type 12 (addressed safety message), ITU-R M.1371-5 § M.3.10."""
    nbits = 72 + 6 * len(text)
    p = bytearray((nbits + 7) // 8)
    set_bitfield(p, 0, 6, 12)
    set_bitfield(p, 8, 30, mmsi)
    set_bitfield(p, 38, 2, seqno)
    set_bitfield(p, 40, 30, dest_mmsi)
    set_bitfield(p, 70, 1, 1 if retransmit else 0)
    set_string(p, 72, len(text), text)
    return bytes(p)


def _set_payload(p: bytearray, offset: int, data: bytes, data_bits: int):
    for k in range(data_bits):
        if (data[k // 8] >> (7 - k % 8)) & 1:
            p[(offset + k) // 8] |= 0x80 >> ((offset + k) % 8)


def make_binary_broadcast(
    mmsi: int, *, dac=1, fi=31, data=b"", data_bits=None,
) -> bytes:
    """Type 8 (binary broadcast), ITU-R M.1371-5 § M.3.8: DAC/FI-keyed
    opaque application payload (left-aligned bits of ``data``)."""
    data_bits = len(data) * 8 if data_bits is None else data_bits
    nbits = 56 + data_bits
    p = bytearray((nbits + 7) // 8)
    set_bitfield(p, 0, 6, 8)
    set_bitfield(p, 8, 30, mmsi)
    set_bitfield(p, 40, 10, dac)
    set_bitfield(p, 50, 6, fi)
    _set_payload(p, 56, data, data_bits)
    return bytes(p)


def make_addressed_binary(
    mmsi: int, dest_mmsi: int, *, dac=1, fi=0, data=b"", data_bits=None,
    seqno=0, retransmit=False,
) -> bytes:
    """Type 6 (addressed binary message), ITU-R M.1371-5 § M.3.6."""
    data_bits = len(data) * 8 if data_bits is None else data_bits
    nbits = 88 + data_bits
    p = bytearray((nbits + 7) // 8)
    set_bitfield(p, 0, 6, 6)
    set_bitfield(p, 8, 30, mmsi)
    set_bitfield(p, 38, 2, seqno)
    set_bitfield(p, 40, 30, dest_mmsi)
    set_bitfield(p, 70, 1, 1 if retransmit else 0)
    set_bitfield(p, 72, 10, dac)
    set_bitfield(p, 82, 6, fi)
    _set_payload(p, 88, data, data_bits)
    return bytes(p)


def packet_to_bits(packet: bytes) -> list[int]:
    """Payload + CRC -> stuffed HDLC bit stream with preamble + flags.

    Returns the NRZI-DECODED bit sequence the receiver should recover.
    """
    crc = crc16_x25(packet)
    framed = bytes(packet) + bytes([crc & 0xFF, crc >> 8])
    # data bits: LSB-first per byte (receiver stores bit k at byte bit k%8)
    data_bits = []
    for b in framed:
        data_bits.extend((b >> i) & 1 for i in range(8))
    # HDLC stuffing: insert a 0 after five consecutive 1s
    stuffed = []
    ones = 0
    for bit in data_bits:
        stuffed.append(bit)
        if bit:
            ones += 1
            if ones == 5:
                stuffed.append(0)
                ones = 0
        else:
            ones = 0
    flag = [0, 1, 1, 1, 1, 1, 1, 0]
    preamble = [i & 1 for i in range(24)]  # 0101... (0x555555 MSB-first)
    return preamble + flag + stuffed + flag


def nrzi_modulate(decoded_bits, amplitude: int = 9000, lead_bits: int = 16,
                  tail_bits: int = 16) -> np.ndarray:
    """Decoded bit 1 == no transition (``bit = !(last ^ cur)``)."""
    levels = []
    level = 1
    for _ in range(lead_bits):
        levels.append(level)  # constant level decodes to 1s
    for bit in decoded_bits:
        if bit == 0:
            level = -level
        levels.append(level)
    for _ in range(tail_bits):
        level = -level  # transitions decode to 0s: keeps rx from idling in 1s
        levels.append(level)
    lv = np.asarray(levels, dtype=np.int16) * amplitude
    return np.repeat(lv, DECIMATION)


def generate(packets: list[bytes], amplitude: int = 9000,
             gap_bits: int = 48) -> np.ndarray:
    """Multiple packets -> one 48 kHz PCM stream."""
    out = []
    for p in packets:
        out.append(nrzi_modulate(packet_to_bits(p), amplitude,
                                 lead_bits=gap_bits, tail_bits=gap_bits))
    return np.concatenate(out)


def make_acknowledge(mmsi: int, acks, *, msg_id: int = 7) -> bytes:
    """Type 7/13 (binary/safety acknowledge), ITU-R M.1371-5 §§ M.3.7/3.11:
    ``acks`` = [(dest_mmsi, seqno), ...] (1-4 pairs)."""
    nbits = 40 + 32 * len(acks)
    p = bytearray((nbits + 7) // 8)
    set_bitfield(p, 0, 6, msg_id)
    set_bitfield(p, 8, 30, mmsi)
    for k, (dest, seq) in enumerate(acks):
        set_bitfield(p, 40 + 32 * k, 30, dest)
        set_bitfield(p, 70 + 32 * k, 2, seq)
    return bytes(p)


def make_utc_inquiry(mmsi: int, dest_mmsi: int) -> bytes:
    """Type 10 (UTC/date inquiry), ITU-R M.1371-5 § M.3.9 (72 bits)."""
    p = bytearray(9)
    set_bitfield(p, 0, 6, 10)
    set_bitfield(p, 8, 30, mmsi)
    set_bitfield(p, 40, 30, dest_mmsi)
    return bytes(p)


def make_interrogation(mmsi: int, targets) -> bytes:
    """Type 15 (interrogation), ITU-R M.1371-5 § M.3.13: ``targets`` =
    [(dest_mmsi, msg_type, slot_offset), ...] — at most two stations, the
    first station optionally asked for a second message type."""
    d1 = targets[0][0]
    same2 = len(targets) >= 2 and targets[1][0] == d1
    rest = targets[2:] if same2 else targets[1:]
    if len(rest) > 1:
        raise ValueError("type 15 interrogates at most two stations")
    nbits = 160 if rest else (110 if same2 else 88)
    p = bytearray((nbits + 7) // 8)
    set_bitfield(p, 0, 6, 15)
    set_bitfield(p, 8, 30, mmsi)
    _, t1, o1 = targets[0]
    set_bitfield(p, 40, 30, d1)
    set_bitfield(p, 70, 6, t1)
    set_bitfield(p, 76, 12, o1)
    if same2:
        _, t12, o12 = targets[1]
        set_bitfield(p, 90, 6, t12)
        set_bitfield(p, 96, 12, o12)
    if rest:
        d2, t2, o2 = rest[0]
        set_bitfield(p, 110, 30, d2)
        set_bitfield(p, 140, 6, t2)
        set_bitfield(p, 146, 12, o2)
    return bytes(p)


def make_assignment_command(mmsi: int, assignments) -> bytes:
    """Type 16 (assignment mode command), ITU-R M.1371-5 § M.3.14:
    ``assignments`` = [(dest_mmsi, slot_offset, increment), ...] (1-2)."""
    nbits = 144 if len(assignments) > 1 else 96
    p = bytearray((nbits + 7) // 8)
    set_bitfield(p, 0, 6, 16)
    set_bitfield(p, 8, 30, mmsi)
    d1, o1, i1 = assignments[0]
    set_bitfield(p, 40, 30, d1)
    set_bitfield(p, 70, 12, o1)
    set_bitfield(p, 82, 10, i1)
    if len(assignments) > 1:
        d2, o2, i2 = assignments[1]
        set_bitfield(p, 92, 30, d2)
        set_bitfield(p, 122, 12, o2)
        set_bitfield(p, 134, 10, i2)
    return bytes(p)


def make_dgnss_broadcast(
    mmsi: int, *, longitude=0.0, latitude=0.0, data=b"", data_bits=None,
) -> bytes:
    """Type 17 (DGNSS broadcast), ITU-R M.1371-5 § M.3.15: 1/10-minute
    reference position + opaque correction payload."""
    data_bits = len(data) * 8 if data_bits is None else data_bits
    nbits = 80 + data_bits
    p = bytearray((nbits + 7) // 8)
    set_bitfield(p, 0, 6, 17)
    set_bitfield(p, 8, 30, mmsi)
    set_bitfield(p, 40, 18, int(round(longitude * 600)) & ((1 << 18) - 1))
    set_bitfield(p, 58, 17, int(round(latitude * 600)) & ((1 << 17) - 1))
    _set_payload(p, 80, data, data_bits)
    return bytes(p)


def make_data_link_management(mmsi: int, reservations) -> bytes:
    """Type 20 (data link management), ITU-R M.1371-5 § M.3.18:
    ``reservations`` = [(slot_offset, number, timeout, increment), ...]."""
    nbits = 40 + 30 * len(reservations)
    p = bytearray((-(-nbits // 8)))
    set_bitfield(p, 0, 6, 20)
    set_bitfield(p, 8, 30, mmsi)
    for k, (offs, num, tmo, inc) in enumerate(reservations):
        b = 40 + 30 * k
        set_bitfield(p, b, 12, offs)
        set_bitfield(p, b + 12, 4, num)
        set_bitfield(p, b + 16, 3, tmo)
        set_bitfield(p, b + 19, 11, inc)
    return bytes(p)


def make_channel_management(
    mmsi: int, *, channel_a=2087, channel_b=2088, txrx_mode=0, power=0,
    ne_lon=0.0, ne_lat=0.0, sw_lon=0.0, sw_lat=0.0,
    dest1=None, dest2=None, band_a=0, band_b=0, zone_size=3,
) -> bytes:
    """Type 22 (channel management), ITU-R M.1371-5 § M.3.20 (168 bits);
    pass dest1/dest2 for the addressed form, a region otherwise."""
    p = bytearray(21)
    set_bitfield(p, 0, 6, 22)
    set_bitfield(p, 8, 30, mmsi)
    set_bitfield(p, 40, 12, channel_a)
    set_bitfield(p, 52, 12, channel_b)
    set_bitfield(p, 64, 4, txrx_mode)
    set_bitfield(p, 68, 1, power)
    if dest1 is not None:
        set_bitfield(p, 69, 30, dest1)
        set_bitfield(p, 104, 30, dest2 or 0)
        set_bitfield(p, 139, 1, 1)
    else:
        set_bitfield(p, 69, 18, int(round(ne_lon * 600)) & ((1 << 18) - 1))
        set_bitfield(p, 87, 17, int(round(ne_lat * 600)) & ((1 << 17) - 1))
        set_bitfield(p, 104, 18, int(round(sw_lon * 600)) & ((1 << 18) - 1))
        set_bitfield(p, 122, 17, int(round(sw_lat * 600)) & ((1 << 17) - 1))
    set_bitfield(p, 140, 1, band_a)
    set_bitfield(p, 141, 1, band_b)
    set_bitfield(p, 142, 3, zone_size)
    return bytes(p)


def make_group_assignment(
    mmsi: int, *, ne_lon=0.0, ne_lat=0.0, sw_lon=0.0, sw_lat=0.0,
    station_type=0, ship_type=0, txrx_mode=0, interval=0, quiet_time=0,
) -> bytes:
    """Type 23 (group assignment command), ITU-R M.1371-5 § M.3.21
    (160 bits)."""
    p = bytearray(20)
    set_bitfield(p, 0, 6, 23)
    set_bitfield(p, 8, 30, mmsi)
    set_bitfield(p, 40, 18, int(round(ne_lon * 600)) & ((1 << 18) - 1))
    set_bitfield(p, 58, 17, int(round(ne_lat * 600)) & ((1 << 17) - 1))
    set_bitfield(p, 75, 18, int(round(sw_lon * 600)) & ((1 << 18) - 1))
    set_bitfield(p, 93, 17, int(round(sw_lat * 600)) & ((1 << 17) - 1))
    set_bitfield(p, 110, 4, station_type)
    set_bitfield(p, 114, 8, ship_type)
    set_bitfield(p, 144, 2, txrx_mode)
    set_bitfield(p, 146, 4, interval)
    set_bitfield(p, 150, 4, quiet_time)
    return bytes(p)


def make_utc_response(mmsi: int, **kwargs) -> bytes:
    """Type 11 (UTC/date response) — the type-4 layout with msg id 11."""
    p = bytearray(make_base_station_report(mmsi, **kwargs))
    p[0] = (p[0] & 0x03) | (11 << 2)
    return bytes(p)


def make_slot_binary(
    mmsi: int, *, msg_id=25, dest_mmsi=None, app_id=None,
    data=b"", data_bits=None, radio_status=None,
) -> bytes:
    """Type 25/26 (single-/multi-slot binary message), ITU-R M.1371-5
    §§ M.3.22/3.23. Type 26's 20-bit comm state sits in the message's
    final 20 bits (byte-granular transport convention)."""
    data_bits = len(data) * 8 if data_bits is None else data_bits
    bit = 40 + (30 if dest_mmsi is not None else 0) \
        + (16 if app_id is not None else 0)
    nbits = bit + data_bits + (20 if msg_id == 26 else 0)
    nbits = -(-nbits // 8) * 8  # byte-granular transport
    p = bytearray(nbits // 8)
    set_bitfield(p, 0, 6, msg_id)
    set_bitfield(p, 8, 30, mmsi)
    pos = 40
    if dest_mmsi is not None:
        set_bitfield(p, 38, 1, 1)
        set_bitfield(p, pos, 30, dest_mmsi)
        pos += 30
    if app_id is not None:
        set_bitfield(p, 39, 1, 1)
        set_bitfield(p, pos, 16, app_id)
        pos += 16
    _set_payload(p, pos, data, data_bits)
    if msg_id == 26:
        set_bitfield(p, nbits - 20, 20, radio_status or 0)
    return bytes(p)
