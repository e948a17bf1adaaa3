"""Open Location Code ("plus code") encoding for photo GPS metadata.

Port of ``spacedrive_tpu/media/pluscodes.py``, a copy: the media rows
carry each photo's GPS position as a plus code, as upstream's
media-metadata crate derives it. This is the standard OLC encoding
algorithm (full codes, default 10-digit precision + optional refinement
grid digit pairs), implemented from the public spec.
"""

from __future__ import annotations

ALPHABET = "23456789CFGHJMPQRVWX"
SEPARATOR = "+"
SEPARATOR_POSITION = 8
PADDING = "0"
LAT_MAX = 90.0
LON_MAX = 180.0
PAIR_CODE_LENGTH = 10
GRID_ROWS = 5
GRID_COLS = 4


MAX_CODE_LENGTH = 15
GRID_CODE_LENGTH = MAX_CODE_LENGTH - PAIR_CODE_LENGTH
# Integer precision of the least-significant digit (OLC spec): pairs
# resolve to 1/8000°, each grid digit refines by 5 (lat) / 4 (lon).
FINAL_LAT_PRECISION = 8000 * GRID_ROWS ** GRID_CODE_LENGTH
FINAL_LON_PRECISION = 8000 * GRID_COLS ** GRID_CODE_LENGTH


def encode(lat: float, lon: float, code_length: int = PAIR_CODE_LENGTH
           ) -> str:
    """Encode a latitude/longitude into a full plus code."""
    if code_length < 2 or (code_length < PAIR_CODE_LENGTH
                           and code_length % 2 == 1):
        raise ValueError(f"invalid code length {code_length}")
    code_length = min(code_length, MAX_CODE_LENGTH)
    lat = min(max(lat, -LAT_MAX), LAT_MAX)
    lon = ((lon + LON_MAX) % (2 * LON_MAX)) - LON_MAX
    if lat == LAT_MAX:  # north pole: shift into the topmost cell
        lat -= _lat_precision(code_length)

    lat_val = int((lat + LAT_MAX) * FINAL_LAT_PRECISION)
    lon_val = int((lon + LON_MAX) * FINAL_LON_PRECISION)

    # Build least-significant first, then reverse.
    digits = []
    for _ in range(GRID_CODE_LENGTH):
        digits.append(ALPHABET[(lat_val % GRID_ROWS) * GRID_COLS
                               + lon_val % GRID_COLS])
        lat_val //= GRID_ROWS
        lon_val //= GRID_COLS
    for _ in range(PAIR_CODE_LENGTH // 2):
        digits.append(ALPHABET[lon_val % 20])
        digits.append(ALPHABET[lat_val % 20])
        lat_val //= 20
        lon_val //= 20
    out = "".join(reversed(digits))[:code_length]
    if code_length < SEPARATOR_POSITION:
        out = out + PADDING * (SEPARATOR_POSITION - code_length)
        return out + SEPARATOR
    return out[:SEPARATOR_POSITION] + SEPARATOR + out[SEPARATOR_POSITION:]


def _lat_precision(code_length: int) -> float:
    if code_length <= PAIR_CODE_LENGTH:
        return 20.0 ** (2 - code_length // 2)
    return (20.0 ** -3) / (GRID_ROWS ** (code_length - PAIR_CODE_LENGTH))
