"""JSON-lines message emitters matching the reference decoder's vocabulary.

The reference prints one JSON object per decoded message with hand-rolled
escaping (``decoder/decoder.c:131-171``): CR and LF both become ``\\n``,
backspace/formfeed become ``<BKSP>``/``<FF>``, ETX/EOT/ETB become a space,
other non-printables ``\\uXXXX``. Key names and structures are kept
identical so downstream consumers of the reference's output work unchanged.
"""

from __future__ import annotations

import time


def escape_message(data: bytes) -> str:
    out = []
    for ch in data:
        c = chr(ch)
        if c == "\n" or c == "\r":
            out.append("\\n")
        elif c == '"':
            out.append('\\"')
        elif c == "\\":
            out.append("\\\\")
        elif c == "/":
            out.append("\\/")
        elif c == "\b":
            out.append("<BKSP>")
        elif c == "\f":
            out.append("<FF>")
        elif c == "\t":
            out.append("\\t")
        elif ch in (0x03, 0x04, 0x17):
            out.append(" ")
        elif 0x20 <= ch <= 0x7E:
            out.append(c)
        else:
            out.append(f"\\u{ch:04x}")
    return "".join(out)


def _ts(now=None) -> str:
    gmt = time.gmtime(now)
    return (
        f"{gmt.tm_year:04d}-{gmt.tm_mon:02d}-{gmt.tm_mday:02d} "
        f"{gmt.tm_hour:02d}:{gmt.tm_min:02d}:{gmt.tm_sec:02d} UTC"
    )


def _flex_frame_ctx(m) -> str:
    """Frame date/time decoded from extra BIWs (pager_flex.c:1036-1086);
    empty when the frame carried none."""
    out = ""
    if m.frame_date is not None:
        y, mo, d = m.frame_date
        out += f'"frameDate":"{y:04d}-{mo:02d}-{d:02d}",'
    if m.frame_time is not None:
        h, mi, sec = m.frame_time
        out += f'"frameTime":"{h:02d}:{mi:02d}:{sec:02d}",'
    return out


def flex_message_json(m, now=None) -> str:
    """tsl_sdr_tpu_torch.models.flex.FlexMessage -> reference JSON line."""
    ts = _ts(now)
    ctx = _flex_frame_ctx(m)
    if m.kind == "alnum":
        return (
            f'{{"proto":"flex","type":"alphanumeric","timestamp":"{ts}",'
            f'"baud":{m.baud},"syncLevel":0,"frameNo":{m.frame},'
            f'"cycleNo":{m.cycle},"phaseNo":"{m.phase}","capCode":{m.capcode},'
            f'{ctx}'
            f'"fragment":{"true" if m.fragment else "false"},'
            f'"maildrop":{"true" if m.maildrop else "false"},'
            f'"fragSeq":{m.seq_num},"message":"{escape_message(m.data)}"}}'
        )
    if m.kind == "numeric":
        return (
            f'{{"proto":"flex","type":"numeric","timestamp":"{ts}",'
            f'"baud":{m.baud},"syncLevel":0,"frameNo":{m.frame},'
            f'"cycleNo":{m.cycle},"phaseNo":"{m.phase}","capCode":{m.capcode},'
            f'{ctx}'
            f'"message":"{escape_message(m.data)}"}}'
        )
    if m.kind == "siv" and m.siv_type == 0:  # temp address activation
        return (
            f'{{"proto":"flex","type":"tempAddrActivation","timestamp":"{ts}",'
            f'"baud":{m.baud},"syncLevel":0,"frameNo":{m.frame},'
            f'"cycleNo":{m.cycle},"phaseNo":"{m.phase}","capCode":{m.capcode},'
            f'"startFrameNo":{m.siv_data & 0x7F},'
            f'"tempAddressId":{(m.siv_data >> 7) & 0xF}}}'
        )
    return ""


def pocsag_message_json(m, now=None) -> str:
    """tsl_sdr_tpu_torch.models.pocsag.PocsagMessage -> reference JSON line."""
    ts = _ts(now)
    kind = "alphanumeric" if m.kind == "alpha" else "numeric"
    return (
        f'{{"proto":"pocsag","type":"{kind}","timestamp":"{ts}",'
        f'"baud":{m.baud},"capCode":{m.capcode},"function":{m.function},'
        f'"message":"{escape_message(m.data)}"}}'
    )


def ais_message_json(m, now=None) -> str:
    """AIS report dataclasses -> reference JSON line."""
    from tsl_sdr_tpu_torch.models.ais import (
        AisAcknowledge,
        AisAidToNavigationReport,
        AisAssignmentCommand,
        AisBaseStationReport,
        AisBinaryMessage,
        AisChannelManagement,
        AisClassBPositionReport,
        AisDataLinkManagement,
        AisDgnssBroadcast,
        AisExtendedClassBReport,
        AisGroupAssignment,
        AisInterrogation,
        AisLongRangePositionReport,
        AisPositionReport,
        AisSafetyMessage,
        AisSarAircraftReport,
        AisSlotBinaryMessage,
        AisStaticDataReport,
        AisStaticVoyageData,
        AisUtcInquiry,
    )

    ts = _ts(now)
    raw = escape_message(m.raw.encode("latin-1"))
    if isinstance(m, AisClassBPositionReport):
        return (
            f'{{"proto":"ais","type":"classBPositionReport","timestamp":"{ts}",'
            f'"mmsi":{m.mmsi},'
            f'"speedOverGround":{m.speed_over_ground:f},'
            f'"positionAcc":{m.position_acc},'
            f'"geoPosition":{{"lon":{m.longitude:f},"lat":{m.latitude:f}}},'
            f'"course":{m.course},"heading":{m.heading},'
            f'"seconds":{m.timestamp},"rawAscii":"{raw}"}}'
        )
    if isinstance(m, AisSarAircraftReport):
        return (
            f'{{"proto":"ais","type":"sarAircraftReport","timestamp":"{ts}",'
            f'"mmsi":{m.mmsi},"altitude":{m.altitude},'
            f'"speedOverGround":{m.speed_over_ground:f},'
            f'"positionAcc":{m.position_acc},'
            f'"geoPosition":{{"lon":{m.longitude:f},"lat":{m.latitude:f}}},'
            f'"course":{m.course},"seconds":{m.timestamp},'
            f'"rawAscii":"{raw}"}}'
        )
    if isinstance(m, AisExtendedClassBReport):
        return (
            f'{{"proto":"ais","type":"extendedClassBReport",'
            f'"timestamp":"{ts}","mmsi":{m.mmsi},'
            f'"speedOverGround":{m.speed_over_ground:f},'
            f'"positionAcc":{m.position_acc},'
            f'"geoPosition":{{"lon":{m.longitude:f},"lat":{m.latitude:f}}},'
            f'"course":{m.course},"heading":{m.heading},'
            f'"seconds":{m.timestamp},'
            f'"name":"{escape_message(m.name.encode("latin-1"))}",'
            f'"shipType":{m.ship_type},'
            f'"dimensions":{{"toBow":{m.dim_to_bow},"toStern":{m.dim_to_stern},'
            f'"toPort":{m.dim_to_port},"toStarboard":{m.dim_to_starboard}}},'
            f'"rawAscii":"{raw}"}}'
        )
    if isinstance(m, AisAidToNavigationReport):
        return (
            f'{{"proto":"ais","type":"aidToNavigation","timestamp":"{ts}",'
            f'"mmsi":{m.mmsi},"aidType":{m.aid_type},'
            f'"name":"{escape_message(m.name.encode("latin-1"))}",'
            f'"geoPosition":{{"lon":{m.longitude:f},"lat":{m.latitude:f}}},'
            f'"offPosition":{str(m.off_position).lower()},'
            f'"virtualAid":{str(m.virtual_aid).lower()},'
            f'"rawAscii":"{raw}"}}'
        )
    if isinstance(m, AisLongRangePositionReport):
        return (
            f'{{"proto":"ais","type":"longRangePosition","timestamp":"{ts}",'
            f'"mmsi":{m.mmsi},"navStat":{m.nav_stat},'
            f'"speedOverGround":{m.speed_over_ground:f},'
            f'"geoPosition":{{"lon":{m.longitude:f},"lat":{m.latitude:f}}},'
            f'"course":{m.course},"rawAscii":"{raw}"}}'
        )
    if isinstance(m, AisStaticDataReport):
        if m.part == "A":
            return (
                f'{{"proto":"ais","type":"staticDataReportA",'
                f'"timestamp":"{ts}","mmsi":{m.mmsi},'
                f'"shipName":"{m.ship_name}","rawAscii":"{raw}"}}'
            )
        return (
            f'{{"proto":"ais","type":"staticDataReportB","timestamp":"{ts}",'
            f'"mmsi":{m.mmsi},"shipType":{m.ship_type},'
            f'"vendorId":"{m.vendor_id}","callsign":"{m.callsign}",'
            f'"dimensions":{{"toBow":{m.dim_to_bow},"toStern":{m.dim_to_stern},'
            f'"toPort":{m.dim_to_port},"toStarboard":{m.dim_to_starboard}}},'
            f'"rawAscii":"{raw}"}}'
        )
    if isinstance(m, AisSafetyMessage):
        kind = ("safetyBroadcast" if m.dest_mmsi is None
                else "addressedSafetyMessage")
        dest = "" if m.dest_mmsi is None else (
            f'"destMmsi":{m.dest_mmsi},"seqNo":{m.seqno},'
            f'"retransmit":{str(m.retransmit).lower()},'
        )
        return (
            f'{{"proto":"ais","type":"{kind}","timestamp":"{ts}",'
            f'"mmsi":{m.mmsi},{dest}'
            f'"text":"{escape_message(m.text.encode("latin-1"))}",'
            f'"rawAscii":"{raw}"}}'
        )
    if isinstance(m, AisBinaryMessage):
        kind = ("binaryBroadcast" if m.dest_mmsi is None
                else "addressedBinaryMessage")
        dest = "" if m.dest_mmsi is None else (
            f'"destMmsi":{m.dest_mmsi},"seqNo":{m.seqno},'
            f'"retransmit":{str(m.retransmit).lower()},'
        )
        return (
            f'{{"proto":"ais","type":"{kind}","timestamp":"{ts}",'
            f'"mmsi":{m.mmsi},{dest}"dac":{m.dac},"fi":{m.fi},'
            f'"dataHex":"{m.data}","dataBits":{m.data_bits},'
            f'"rawAscii":"{raw}"}}'
        )
    if isinstance(m, AisPositionReport):
        return (
            f'{{"proto":"ais","type":"positionReport","timestamp":"{ts}",'
            f'"mmsi":{m.mmsi},"navStat":{m.nav_stat},'
            f'"rateOfTurn":{m.rate_of_turn},'
            f'"speedOverGround":{m.speed_over_ground:f},'
            f'"positionAcc":{m.position_acc},'
            f'"geoPosition":{{"lon":{m.longitude:f},"lat":{m.latitude:f}}},'
            f'"course":{m.course},"heading":{m.heading},'
            f'"seconds":{m.timestamp},"rawAscii":"{raw}"}}'
        )
    if isinstance(m, AisAcknowledge):
        kind = "binaryAcknowledge" if m.msg_id == 7 else "safetyAcknowledge"
        acks = ",".join(
            f'{{"destMmsi":{d},"seqNo":{s}}}' for d, s in m.acks)
        return (
            f'{{"proto":"ais","type":"{kind}","timestamp":"{ts}",'
            f'"mmsi":{m.mmsi},"acks":[{acks}],"rawAscii":"{raw}"}}'
        )
    if isinstance(m, AisUtcInquiry):
        return (
            f'{{"proto":"ais","type":"utcInquiry","timestamp":"{ts}",'
            f'"mmsi":{m.mmsi},"destMmsi":{m.dest_mmsi},"rawAscii":"{raw}"}}'
        )
    if isinstance(m, AisInterrogation):
        tgts = ",".join(
            f'{{"destMmsi":{d},"msgType":{t},"slotOffset":{o}}}'
            for d, t, o in m.targets)
        return (
            f'{{"proto":"ais","type":"interrogation","timestamp":"{ts}",'
            f'"mmsi":{m.mmsi},"targets":[{tgts}],"rawAscii":"{raw}"}}'
        )
    if isinstance(m, AisAssignmentCommand):
        asg = ",".join(
            f'{{"destMmsi":{d},"slotOffset":{o},"increment":{i}}}'
            for d, o, i in m.assignments)
        return (
            f'{{"proto":"ais","type":"assignmentCommand","timestamp":"{ts}",'
            f'"mmsi":{m.mmsi},"assignments":[{asg}],"rawAscii":"{raw}"}}'
        )
    if isinstance(m, AisDgnssBroadcast):
        return (
            f'{{"proto":"ais","type":"dgnssBroadcast","timestamp":"{ts}",'
            f'"mmsi":{m.mmsi},'
            f'"refPosition":{{"lon":{m.longitude:f},"lat":{m.latitude:f}}},'
            f'"data":"{m.data}","dataBits":{m.data_bits},'
            f'"rawAscii":"{raw}"}}'
        )
    if isinstance(m, AisSlotBinaryMessage):
        kind = ("singleSlotBinary" if m.msg_id == 25
                else "multiSlotBinary")
        extra = ""
        if m.dest_mmsi is not None:
            extra += f'"destMmsi":{m.dest_mmsi},'
        if m.app_id is not None:
            extra += f'"appId":{m.app_id},'
        if m.radio_status is not None:
            extra += f'"radioStatus":{m.radio_status},'
        return (
            f'{{"proto":"ais","type":"{kind}","timestamp":"{ts}",'
            f'"mmsi":{m.mmsi},{extra}'
            f'"data":"{m.data}","dataBits":{m.data_bits},'
            f'"rawAscii":"{raw}"}}'
        )
    if isinstance(m, AisDataLinkManagement):
        res = ",".join(
            f'{{"slotOffset":{o},"slots":{n},"timeoutMin":{t},'
            f'"increment":{i}}}' for o, n, t, i in m.reservations)
        return (
            f'{{"proto":"ais","type":"dataLinkManagement",'
            f'"timestamp":"{ts}","mmsi":{m.mmsi},'
            f'"reservations":[{res}],"rawAscii":"{raw}"}}'
        )
    if isinstance(m, AisChannelManagement):
        if m.addressed:
            scope = f'"destMmsi1":{m.dest1},"destMmsi2":{m.dest2}'
        else:
            scope = (f'"region":{{"neLon":{m.ne_lon:f},"neLat":{m.ne_lat:f},'
                     f'"swLon":{m.sw_lon:f},"swLat":{m.sw_lat:f}}}')
        return (
            f'{{"proto":"ais","type":"channelManagement",'
            f'"timestamp":"{ts}","mmsi":{m.mmsi},'
            f'"channelA":{m.channel_a},"channelB":{m.channel_b},'
            f'"txRxMode":{m.txrx_mode},"power":{m.power},'
            f'"addressed":{"true" if m.addressed else "false"},{scope},'
            f'"bandA":{m.band_a},"bandB":{m.band_b},'
            f'"zoneSize":{m.zone_size},"rawAscii":"{raw}"}}'
        )
    if isinstance(m, AisGroupAssignment):
        return (
            f'{{"proto":"ais","type":"groupAssignment","timestamp":"{ts}",'
            f'"mmsi":{m.mmsi},'
            f'"region":{{"neLon":{m.ne_lon:f},"neLat":{m.ne_lat:f},'
            f'"swLon":{m.sw_lon:f},"swLat":{m.sw_lat:f}}},'
            f'"stationType":{m.station_type},"shipType":{m.ship_type},'
            f'"txRxMode":{m.txrx_mode},"reportingInterval":{m.interval},'
            f'"quietTime":{m.quiet_time},"rawAscii":"{raw}"}}'
        )
    if isinstance(m, AisBaseStationReport):
        kind = ("baseStationReport" if m.msg_id == 4
                else "utcDateResponse")
        return (
            f'{{"proto":"ais","type":"{kind}","timestamp":"{ts}",'
            f'"mmsi":{m.mmsi},'
            f'"baseStationDate":"{m.year:04d}-{m.month:02d}-{m.day:02d} '
            f'{m.hour:02d}:{m.minute:02d}:{m.second:02d} UTC",'
            f'"geoPosition":{{"lon":{m.longitude:f},"lat":{m.latitude:f}}},'
            f'"fixType":"{m.epfd_name}","rawAscii":"{raw}"}}'
        )
    if isinstance(m, AisStaticVoyageData):
        return (
            f'{{"proto":"ais","type":"staticAndVoyageData","timestamp":"{ts}",'
            f'"mmsi":{m.mmsi},"version":{m.version},'
            f'"imoNumber":{m.imo_number},"callsign":"{m.callsign}",'
            f'"shipName":"{m.ship_name}","shipType":{m.ship_type},'
            f'"dimensions":{{"toBow":{m.dim_to_bow},"toStern":{m.dim_to_stern},'
            f'"toPort":{m.dim_to_port},"toStarboard":{m.dim_to_starboard}}},'
            f'"fixType":"{m.epfd_name}",'
            f'"eta":"{m.eta_month:02d}-{m.eta_day:02d} '
            f'{m.eta_hour:02d}:{m.eta_minute:02d}","draught":{m.draught:f},'
            f'"destination":"{m.destination}","rawAscii":"{raw}"}}'
        )
    return ""


def message_to_json(m, freq_hz=None, now=None) -> str:
    """Dispatch any decoded message to its reference JSON form, optionally
    tagged with the channel's center frequency."""
    from tsl_sdr_tpu_torch.models.flex import FlexMessage
    from tsl_sdr_tpu_torch.models.pocsag import PocsagMessage

    if isinstance(m, FlexMessage):
        s = flex_message_json(m, now)
    elif isinstance(m, PocsagMessage):
        s = pocsag_message_json(m, now)
    else:
        s = ais_message_json(m, now)
    if s and freq_hz is not None:
        s = s[:-1] + f',"freqHz":{int(freq_hz)}}}'
    return s
