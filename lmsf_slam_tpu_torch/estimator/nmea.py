"""NMEA-0183 sentence ingestion → LLA fixes.

Counterpart of ``lmsf_slam_tpu/estimator/nmea.py`` (a copy: importing that
module would run the reference package's ``__init__``). Host-side
pure-Python string processing at GNSS rate (≤10 Hz); the output LLA feeds
:func:`.gnss.lla_to_enu` / ``MultiLidarSystem.process_gnss`` unchanged.

Supported sentences (talker-agnostic: GP/GN/GL/GA/BD…):
- ``GGA`` — position fix: lat/lon/alt, fix quality, satellite count, HDOP;
- ``RMC`` — recommended minimum: lat/lon, validity flag, speed/course.

Checksums are validated when present; malformed or void sentences return
``None`` instead of raising (a serial stream drops bytes — ingest must not
crash the pipeline).
"""
from __future__ import annotations

from typing import NamedTuple, Optional


class NmeaFix(NamedTuple):
    lla: tuple  # (lat°, lon°, alt m) — alt 0.0 for RMC sentences
    utc: float  # seconds since UTC midnight (nan if absent)
    quality: int  # GGA fix quality (0 invalid … 5 float RTK); RMC valid → 1
    n_sats: int  # satellites in use (-1 if not reported)
    hdop: float  # horizontal dilution of precision (nan if not reported)


def _checksum_ok(sentence: str) -> bool:
    """Validate the *hh trailer when present (XOR of bytes between $ and *)."""
    if "*" not in sentence:
        return True
    body, _, tail = sentence.partition("*")
    try:
        want = int(tail.strip()[:2], 16)
    except ValueError:
        return False
    acc = 0
    for ch in body[1:]:  # skip '$'
        acc ^= ord(ch)
    return acc == want


def _dm_to_deg(dm: str, hemi: str) -> Optional[float]:
    """NMEA ddmm.mmmm / dddmm.mmmm + hemisphere → signed decimal degrees."""
    if not dm or not hemi:
        return None
    try:
        v = float(dm)
    except ValueError:
        return None
    deg = int(v // 100)
    minutes = v - 100 * deg
    out = deg + minutes / 60.0
    return -out if hemi in ("S", "W") else out


def _utc(hms: str) -> float:
    try:
        v = float(hms)
    except (TypeError, ValueError):
        return float("nan")
    h = int(v // 10000)
    m = int((v - 10000 * h) // 100)
    s = v - 10000 * h - 100 * m
    return 3600.0 * h + 60.0 * m + s


def parse_nmea(sentence: str) -> Optional[NmeaFix]:
    """Parse one NMEA sentence; ``None`` for non-position / invalid input."""
    sentence = sentence.strip()
    if not sentence.startswith("$") or not _checksum_ok(sentence):
        return None
    body = sentence[1:].partition("*")[0]
    f = body.split(",")
    typ = f[0][-3:] if len(f[0]) >= 3 else ""

    if typ == "GGA" and len(f) >= 10:
        lat = _dm_to_deg(f[2], f[3])
        lon = _dm_to_deg(f[4], f[5])
        try:
            quality = int(f[6]) if f[6] else 0
        except ValueError:
            return None
        if lat is None or lon is None or quality == 0:
            return None
        try:
            n_sats = int(f[7]) if f[7] else -1
        except ValueError:
            n_sats = -1
        try:
            hdop = float(f[8]) if f[8] else float("nan")
        except ValueError:
            hdop = float("nan")
        try:
            alt = float(f[9]) if f[9] else 0.0
        except ValueError:
            alt = 0.0
        return NmeaFix((lat, lon, alt), _utc(f[1]), quality, n_sats, hdop)

    if typ == "RMC" and len(f) >= 7:
        if f[2] != "A":  # V = void
            return None
        lat = _dm_to_deg(f[3], f[4])
        lon = _dm_to_deg(f[5], f[6])
        if lat is None or lon is None:
            return None
        return NmeaFix((lat, lon, 0.0), _utc(f[1]), 1, -1, float("nan"))

    return None


class NmeaStream:
    """Incremental line-splitter over raw serial chunks → NmeaFix events.

    ``feed(bytes_or_str)`` returns the fixes completed by this chunk; partial
    trailing lines are buffered (serial reads split sentences arbitrarily).
    """

    # NMEA 0183 caps sentences at 82 chars; a terminator-free buffer beyond
    # this is binary garbage or a wedged serial line — discard the stale
    # head so the buffer cannot grow without bound
    MAX_SENTENCE = 82

    def __init__(self):
        self._buf = ""

    def feed(self, chunk) -> list:
        if isinstance(chunk, bytes):
            chunk = chunk.decode("ascii", errors="replace")
        self._buf += chunk
        *lines, self._buf = self._buf.replace("\r", "\n").split("\n")
        if len(self._buf) > self.MAX_SENTENCE:
            # keep only a sentence-length tail (a '$' may still arrive)
            self._buf = self._buf[-self.MAX_SENTENCE:]
        out = []
        for line in lines:
            fix = parse_nmea(line)
            if fix is not None:
                out.append(fix)
        return out
