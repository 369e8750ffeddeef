"""Image validation, EXIF extraction, resize/re-encode, fallback captions.

Host-CPU only (SURVEY.md §2: PIL/piexif stays host-side in any build).
Behavior-parity target: reference utils/image_parser.py:1-240 — extension
whitelist + PIL verify, DateTimeOriginal||DateTime ISO datetime, camera
Make+Model, hemisphere-signed GPS, EXIF-transpose + LANCZOS downscale
re-encode, filename-token fallback description.
"""

from __future__ import annotations

import io
import os
import re
from datetime import datetime
from typing import Any, Dict, Optional, Tuple

from PIL import Image, ImageOps

SUPPORTED_EXTENSIONS = {".jpg", ".jpeg", ".png", ".webp"}

# EXIF tag ids (TIFF/EXIF standard numbering; read via PIL's native
# Image.getexif() so no piexif dependency is needed).
_TAG_MAKE = 271
_TAG_MODEL = 272
_TAG_ORIENTATION = 274
_TAG_DATETIME = 306
_TAG_DATETIME_ORIGINAL = 36867
_IFD_EXIF = 0x8769
_IFD_GPS = 0x8825
_TAG_GPS_LAT_REF = 1
_TAG_GPS_LAT = 2
_TAG_GPS_LON_REF = 3
_TAG_GPS_LON = 4


def is_valid_image(file_path: str) -> bool:
    """Extension whitelist + PIL verify (reference image_parser.py:11-36)."""
    if not file_path or not os.path.isfile(file_path):
        return False
    if os.path.splitext(file_path)[1].lower() not in SUPPORTED_EXTENSIONS:
        return False
    try:
        with Image.open(file_path) as image:
            image.verify()
        return True
    except Exception:
        return False


def _decode(value: Any) -> Optional[str]:
    if isinstance(value, (bytes, bytearray)):
        return value.decode("utf-8", errors="ignore")
    if isinstance(value, str):
        return value
    return None


def _exif_datetime_to_iso(value: Any) -> Optional[str]:
    text = _decode(value)
    if not text:
        return None
    try:
        return datetime.strptime(text.strip().rstrip("\x00"), "%Y:%m:%d %H:%M:%S").isoformat()
    except Exception:
        return None


def _to_float(value: Any) -> Optional[float]:
    """PIL exposes EXIF rationals as IFDRational (float-convertible) or
    (num, den) tuples; accept both."""
    try:
        if isinstance(value, tuple) and len(value) == 2:
            num, den = value
            if den == 0:
                return None
            return float(num) / float(den)
        return float(value)
    except Exception:
        return None


def _dms_to_degrees(values: Any) -> Optional[float]:
    if not values or len(values) != 3:
        return None
    d, m, s = (_to_float(v) for v in values)
    if d is None or m is None or s is None:
        return None
    return d + m / 60.0 + s / 3600.0


def extract_exif_metadata(file_path: str) -> Dict[str, Any]:
    """Return {datetime, camera, gps{lat,lon}, orientation}
    (reference image_parser.py:67-131)."""
    metadata: Dict[str, Any] = {
        "datetime": None,
        "camera": None,
        "gps": None,
        "orientation": None,
    }
    if not is_valid_image(file_path):
        return metadata

    try:
        with Image.open(file_path) as image:
            exif = image.getexif()
            if not exif:
                return metadata
            try:
                exif_ifd = dict(exif.get_ifd(_IFD_EXIF))
            except Exception:
                exif_ifd = {}
            try:
                gps = dict(exif.get_ifd(_IFD_GPS))
            except Exception:
                gps = {}
            zeroth = dict(exif)
    except Exception:
        return metadata

    # DateTimeOriginal preferred over DateTime (reference image_parser.py:96-100).
    raw_dt = exif_ifd.get(_TAG_DATETIME_ORIGINAL) or zeroth.get(_TAG_DATETIME)
    metadata["datetime"] = _exif_datetime_to_iso(raw_dt)

    make = _decode(zeroth.get(_TAG_MAKE))
    model = _decode(zeroth.get(_TAG_MODEL))
    if make and model:
        metadata["camera"] = f"{make} {model}".strip()
    else:
        metadata["camera"] = make or model

    orientation = zeroth.get(_TAG_ORIENTATION)
    metadata["orientation"] = int(orientation) if orientation is not None else None

    if gps:
        lat = _dms_to_degrees(gps.get(_TAG_GPS_LAT))
        lon = _dms_to_degrees(gps.get(_TAG_GPS_LON))
        if lat is not None and _decode(gps.get(_TAG_GPS_LAT_REF)) == "S":
            lat = -lat
        if lon is not None and _decode(gps.get(_TAG_GPS_LON_REF)) == "W":
            lon = -lon
        if lat is not None and lon is not None:
            metadata["gps"] = {"lat": lat, "lon": lon}

    return metadata


def get_file_time(file_path: str) -> Optional[str]:
    """mtime as ISO string (reference image_parser.py:134-148)."""
    try:
        return datetime.fromtimestamp(os.path.getmtime(file_path)).isoformat()
    except Exception:
        return None


def get_image_dimensions(file_path: str) -> Tuple[int, int]:
    """Orientation-corrected (width, height); (0, 0) on failure."""
    try:
        with Image.open(file_path) as image:
            corrected = ImageOps.exif_transpose(image)
            return corrected.size
    except Exception:
        return 0, 0


def filename_tokens(file_path: str) -> list:
    """Non-numeric word tokens of the filename stem (shared by the
    fallback caption and the local vision backend's tag derivation)."""
    stem = os.path.splitext(os.path.basename(file_path))[0]
    return [t for t in re.split(r"[\W_]+", stem) if t and not t.isdigit()]


def generate_fallback_description(file_path: str) -> str:
    """Filename-token fallback caption (reference image_parser.py:169-185)."""
    tokens = filename_tokens(file_path)
    if not tokens:
        return "一张照片"
    if len(tokens) == 1:
        return f"与{tokens[0]}相关的照片"
    return f"与{tokens[0]}和{tokens[1]}相关的照片"


def resize_and_optimize_image(
    file_path: str,
    max_size: int = 1024,
    quality: int = 85,
    format: str = "JPEG",
) -> bytes:
    """EXIF-transpose, LANCZOS downscale to max edge, re-encode
    (reference image_parser.py:188-240).  Falls back to raw bytes on error."""
    try:
        with Image.open(file_path) as image:
            corrected = ImageOps.exif_transpose(image)
            width, height = corrected.size
            if width > max_size or height > max_size:
                if width > height:
                    new_size = (max_size, int(height * max_size / width))
                else:
                    new_size = (int(width * max_size / height), max_size)
                corrected = corrected.resize(new_size, Image.Resampling.LANCZOS)

            buffer = io.BytesIO()
            fmt = format.upper()
            if fmt == "WEBP":
                corrected.save(buffer, format="WEBP", quality=quality, lossless=False)
            elif fmt == "PNG":
                corrected.save(buffer, format="PNG", optimize=True)
            else:
                if corrected.mode != "RGB":
                    corrected = corrected.convert("RGB")
                corrected.save(buffer, format="JPEG", quality=quality, optimize=True)
            return buffer.getvalue()
    except Exception:
        with open(file_path, "rb") as f:
            return f.read()
