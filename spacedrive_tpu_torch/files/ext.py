"""Extension taxonomy + magic-byte disambiguation.

The port's own copy of ``spacedrive_tpu/files/ext.py``, unchanged.

Covers the behavior of the reference's `sd-file-ext` crate
(upstream crates/file-ext/src/extensions.rs:11-564,
upstream crates/file-ext/src/magic.rs:12-236): map a file extension to
an ObjectKind category, and when extensions conflict across categories (or a
caller forces verification), check magic bytes read from the file header.

The Rust macro soup becomes one flat table: category → {ext: signatures},
where each signature is (offset, pattern, mask). A zero mask byte is a
wildcard (the reference's `_`). An empty signature list means "extension is
trusted as-is" (no magic bytes known).
"""

from __future__ import annotations

import os
from typing import BinaryIO, Dict, List, Optional, Sequence, Tuple

from .kinds import ObjectKind

# One signature: (offset, pattern bytes, mask bytes — 0x00 = wildcard).
Signature = Tuple[int, bytes, bytes]


def _sig(pattern: Sequence[Optional[int]], offset: int = 0) -> Signature:
    pat = bytes(0 if b is None else b for b in pattern)
    mask = bytes(0 if b is None else 0xFF for b in pattern)
    return (offset, pat, mask)


_ = None  # wildcard byte inside signatures, matching the reference notation

# category name → {extension → [signatures]} — extensions.rs:31-362.
EXTENSION_TABLE: Dict[str, Dict[str, List[Signature]]] = {
    "video": {
        "avi": [_sig([0x52, 0x49, 0x46, 0x46, _, _, _, _, 0x41, 0x56, 0x49, 0x20])],
        "qt": [_sig([0x71, 0x74, 0x20, 0x20])],
        "mov": [_sig([0x66, 0x74, 0x79, 0x70, 0x71, 0x74, 0x20, 0x20], 4)],
        "swf": [_sig([0x5A, 0x57, 0x53]), _sig([0x46, 0x57, 0x53])],
        "mjpeg": [],
        "ts": [_sig([0x47])],
        "mts": [_sig([0x47]), _sig([_, _, _, 0x47])],
        "mpeg": [_sig([0x47]), _sig([0x00, 0x00, 0x01, 0xBA]),
                 _sig([0x00, 0x00, 0x01, 0xB3])],
        "mxf": [_sig([0x06, 0x0E, 0x2B, 0x34, 0x02, 0x05, 0x01, 0x01,
                      0x0D, 0x01, 0x02, 0x01, 0x01, 0x02])],
        "m2v": [_sig([0x00, 0x00, 0x01, 0xBA])],
        "mpg": [],
        "mpe": [],
        "m2ts": [],
        "flv": [_sig([0x46, 0x4C, 0x56])],
        "wm": [],
        "3gp": [],
        "m4v": [_sig([0x66, 0x74, 0x79, 0x70, 0x4D, 0x34, 0x56], 4)],
        "wmv": [_sig([0x30, 0x26, 0xB2, 0x75, 0x8E, 0x66, 0xCF, 0x11,
                      0xA6, 0xD9, 0x00, 0xAA, 0x00, 0x62, 0xCE, 0x6C])],
        "asf": [_sig([0x30, 0x26, 0xB2, 0x75, 0x8E, 0x66, 0xCF, 0x11,
                      0xA6, 0xD9, 0x00, 0xAA, 0x00, 0x62, 0xCE, 0x6C])],
        "mp4": [],
        "webm": [_sig([0x1A, 0x45, 0xDF, 0xA3])],
        "mkv": [_sig([0x1A, 0x45, 0xDF, 0xA3])],
        "vob": [_sig([0x00, 0x00, 0x01, 0xBA])],
        "ogv": [_sig([0x4F, 0x67, 0x67, 0x53])],
        "wtv": [_sig([0xB7, 0xD8, 0x00])],
        "hevc": [],
        "f4v": [_sig([0x66, 0x74, 0x79, 0x70, 0x66, 0x72, 0x65, 0x65], 4)],
    },
    "image": {
        "jpg": [_sig([0xFF, 0xD8])],
        "jpeg": [_sig([0xFF, 0xD8])],
        "png": [_sig([0x89, 0x50, 0x4E, 0x47, 0x0D, 0x0A, 0x1A, 0x0A])],
        "apng": [_sig([0x89, 0x50, 0x4E, 0x47, 0x0D, 0x0A, 0x1A, 0x0A,
                       0x00, 0x00, 0x00, 0x0D, 0x49, 0x48, 0x44, 0x52])],
        "gif": [_sig([0x47, 0x49, 0x46, 0x38, _, 0x61])],
        "bmp": [_sig([0x42, 0x4D])],
        "tiff": [_sig([0x49, 0x49, 0x2A, 0x00])],
        "webp": [_sig([0x52, 0x49, 0x46, 0x46, _, _, _, _, 0x57, 0x45, 0x42, 0x50])],
        "svg": [_sig([0x3C, 0x73, 0x76, 0x67])],
        "ico": [_sig([0x00, 0x00, 0x01, 0x00])],
        "heic": [_sig([0x00, 0x00, 0x00, 0x18, 0x66, 0x74, 0x79, 0x70,
                       0x68, 0x65, 0x69, 0x63])],
        "heics": [_sig([0x00, 0x00, 0x00, 0x18, 0x66, 0x74, 0x79, 0x70,
                        0x68, 0x65, 0x69, 0x63])],
        "heif": [],
        "heifs": [],
        "hif": [],
        "avif": [],
        "avci": [],
        "avcs": [],
        "raw": [],
        "akw": [_sig([0x41, 0x4B, 0x57, 0x42])],
        "dng": [_sig([0x49, 0x49, 0x2A, 0x00, 0x08, 0x00, 0x00, 0x00,
                      0x44, 0x4E, 0x47, 0x00])],
        "cr2": [_sig([0x49, 0x49, 0x2A, 0x00, 0x10, 0x00, 0x00, 0x00,
                      0x43, 0x52, 0x02, 0x00])],
        "dcr": [_sig([0x49, 0x49, 0x2A, 0x00, 0x10, 0x00, 0x00, 0x00,
                      0x44, 0x43, 0x52, 0x00])],
        "nwr": [_sig([0x49, 0x49, 0x2A, 0x00, 0x10, 0x00, 0x00, 0x00,
                      0x4E, 0x57, 0x52, 0x00])],
        "nef": [_sig([0x49, 0x49, 0x2A, 0x00, 0x08, 0x00, 0x00, 0x00,
                      0x4E, 0x45, 0x46, 0x00])],
        "arw": [_sig([0x49, 0x49, 0x2A, 0x00, 0x08])],
        "rw2": [_sig([0x49, 0x49, 0x2A, 0x00, 0x18])],
    },
    "audio": {
        "mp3": [_sig([0x49, 0x44, 0x33])],
        "mp2": [_sig([0xFF, 0xFB]), _sig([0xFF, 0xFD])],
        "m4a": [_sig([0x66, 0x74, 0x79, 0x70, 0x4D, 0x34, 0x41, 0x20], 4)],
        "wav": [_sig([0x52, 0x49, 0x46, 0x46, _, _, _, _, 0x57, 0x41, 0x56, 0x45])],
        "aiff": [_sig([0x46, 0x4F, 0x52, 0x4D, _, _, _, _, 0x41, 0x49, 0x46, 0x46])],
        "aif": [_sig([0x46, 0x4F, 0x52, 0x4D, _, _, _, _, 0x41, 0x49, 0x46, 0x46])],
        "flac": [_sig([0x66, 0x4C, 0x61, 0x43])],
        "ogg": [_sig([0x4F, 0x67, 0x67, 0x53])],
        "oga": [_sig([0x4F, 0x67, 0x67, 0x53])],
        "opus": [_sig([0x4F, 0x70, 0x75, 0x73, 0x48, 0x65, 0x61, 0x64], 28)],
        "wma": [_sig([0x30, 0x26, 0xB2, 0x75, 0x8E, 0x66, 0xCF, 0x11,
                      0xA6, 0xD9, 0x00, 0xAA, 0x00, 0x62, 0xCE, 0x6C])],
        "amr": [_sig([0x23, 0x21, 0x41, 0x4D, 0x52])],
        "aac": [_sig([0xFF, 0xF1])],
        "wv": [_sig([0x77, 0x76, 0x70, 0x6B])],
        "voc": [_sig(list(b"Creative Voice File"))],
        "tta": [_sig([0x54, 0x54, 0x41])],
        "loas": [_sig([0x56, 0xE0])],
        "caf": [_sig([0x63, 0x61, 0x66, 0x66])],
        "aptx": [_sig([0x4B, 0xBF, 0x4B, 0xBF])],
        "adts": [_sig([0xFF, 0xF1])],
        "ast": [_sig([0x53, 0x54, 0x52, 0x4D])],
    },
    "archive": {
        "zip": [_sig([0x50, 0x4B, 0x03, 0x04])],
        "rar": [_sig([0x52, 0x61, 0x72, 0x21, 0x1A, 0x07, 0x00])],
        "tar": [_sig([0x75, 0x73, 0x74, 0x61, 0x72])],
        "gz": [_sig([0x1F, 0x8B, 0x08])],
        "bz2": [_sig([0x42, 0x5A, 0x68])],
        "7z": [_sig([0x37, 0x7A, 0xBC, 0xAF, 0x27, 0x1C])],
        "xz": [_sig([0xFD, 0x37, 0x7A, 0x58, 0x5A, 0x00])],
    },
    "executable": {
        "exe": [_sig([0x4D, 0x5A])],
        "app": [_sig([0x4D, 0x5A])],
        "apk": [_sig([0x50, 0x4B, 0x03, 0x04])],
        "deb": [_sig(list(b"!<arch>\ndebian-binary"))],
        "dmg": [_sig([0x78, 0x01, 0x73, 0x0D, 0x62, 0x62, 0x60])],
        "pkg": [_sig([0x4D, 0x5A])],
        "rpm": [_sig([0xED, 0xAB, 0xEE, 0xDB])],
        "msi": [_sig([0xD0, 0xCF, 0x11, 0xE0, 0xA1, 0xB1, 0x1A, 0xE1])],
        "jar": [_sig([0x50, 0x4B, 0x03, 0x04])],
        "bat": [],
    },
    "document": {
        "pdf": [_sig([0x25, 0x50, 0x44, 0x46, 0x2D])],
        "key": [_sig([0x50, 0x4B, 0x03, 0x04])],
        "pages": [_sig([0x50, 0x4B, 0x03, 0x04])],
        "numbers": [_sig([0x50, 0x4B, 0x03, 0x04])],
        "doc": [_sig([0xD0, 0xCF, 0x11, 0xE0, 0xA1, 0xB1, 0x1A, 0xE1])],
        "docx": [_sig([0x50, 0x4B, 0x03, 0x04])],
        "xls": [_sig([0xD0, 0xCF, 0x11, 0xE0, 0xA1, 0xB1, 0x1A, 0xE1])],
        "xlsx": [_sig([0x50, 0x4B, 0x03, 0x04])],
        "ppt": [_sig([0xD0, 0xCF, 0x11, 0xE0, 0xA1, 0xB1, 0x1A, 0xE1])],
        "pptx": [_sig([0x50, 0x4B, 0x03, 0x04])],
        "odt": [_sig([0x50, 0x4B, 0x03, 0x04])],
        "ods": [_sig([0x50, 0x4B, 0x03, 0x04])],
        "odp": [_sig([0x50, 0x4B, 0x03, 0x04])],
        "ics": [_sig(list(b"BEGIN:VCARD"))],
        "hwp": [_sig([0xD0, 0xCF, 0x11, 0xE0, 0xA1, 0xB1, 0x1A, 0xE1])],
    },
    "text": {ext: [] for ext in ("txt", "rtf", "md", "markdown")},
    "config": {ext: [] for ext in (
        "ini", "json", "yaml", "yml", "toml", "xml", "mathml", "rss",
        "csv", "cfg", "compose", "tsconfig",
    )},
    "encrypted": {
        "bytes": [_sig(list(b"ballapp"))],
        "container": [_sig(list(b"sdbox"))],
        "block": [_sig(list(b"sdblock"))],
    },
    "key": {ext: [] for ext in ("pgp", "pub", "pem", "p12", "p8", "keychain")},
    "font": {
        "ttf": [_sig([0x00, 0x01, 0x00, 0x00, 0x00])],
        "otf": [_sig([0x4F, 0x54, 0x54, 0x4F, 0x00])],
        "woff": [_sig([0x77, 0x4F, 0x46, 0x46])],
        "woff2": [_sig([0x77, 0x4F, 0x46, 0x32])],
    },
    "mesh": {
        "fbx": [_sig([0x46, 0x42, 0x58, 0x20])],
        "obj": [_sig([0x6F, 0x62, 0x6A])],
    },
    "code": {ext: [] for ext in (
        "scpt", "scptd", "applescript", "sh", "zsh", "fish", "bash",
        "c", "cpp", "h", "hpp", "rb", "js", "mjs", "jsx", "html", "css",
        "sass", "scss", "less", "cr", "cs", "csx", "d", "dart",
        "dockerfile", "go", "hs", "java", "kt", "kts", "lua", "make",
        "nim", "nims", "m", "mm", "ml", "mli", "mll", "mly", "pl", "php",
        "php1", "php2", "php3", "php4", "php5", "php6", "phps", "phpt",
        "phtml", "ps1", "psd1", "psm1", "py", "qml", "r", "rs", "sol",
        "sql", "swift", "ts", "tsx", "vala", "zig", "vue", "scala",
        "mdx", "astro", "mts",
    )},
    "database": {
        "sqlite": [_sig(list(b"SQLite format 3\x00"))],
        "db": [],
    },
    "book": {
        "azw": [_sig([0x52, 0x49, 0x46, 0x46])],
        "azw3": [_sig([0x52, 0x49, 0x46, 0x46])],
        "epub": [_sig([0x50, 0x4B, 0x03, 0x04])],
        "mobi": [_sig([0x4D, 0x4F, 0x42, 0x49])],
    },
}

CATEGORY_KIND: Dict[str, ObjectKind] = {
    "document": ObjectKind.DOCUMENT,
    "video": ObjectKind.VIDEO,
    "image": ObjectKind.IMAGE,
    "audio": ObjectKind.AUDIO,
    "archive": ObjectKind.ARCHIVE,
    "executable": ObjectKind.EXECUTABLE,
    "text": ObjectKind.TEXT,
    "encrypted": ObjectKind.ENCRYPTED,
    "key": ObjectKind.KEY,
    "font": ObjectKind.FONT,
    "mesh": ObjectKind.MESH,
    "code": ObjectKind.CODE,
    "database": ObjectKind.DATABASE,
    "book": ObjectKind.BOOK,
    "config": ObjectKind.CONFIG,
}

# Category priority for conflicts mirrors the declaration order of the
# reference's `Extension` enum (extensions.rs:12-28): the first listed
# category wins when from_str finds several and no magic check runs.
_CATEGORY_ORDER = (
    "document", "video", "image", "audio", "archive", "executable",
    "text", "encrypted", "key", "font", "mesh", "code", "database",
    "book", "config",
)


def extension_candidates(ext: str) -> List[str]:
    """Categories claiming this extension, in enum declaration order."""
    e = ext.lower()
    return [c for c in _CATEGORY_ORDER if e in EXTENSION_TABLE[c]]


def _match_sig(buf: bytes, sig: Signature) -> bool:
    offset, pat, mask = sig
    # The reference reads exactly len(pat) bytes at offset and fails the
    # check on short reads (magic.rs:161-175).
    window = buf[offset:offset + len(pat)]
    if len(window) != len(pat):
        return False
    return all((b & m) == (p & m) for b, p, m in zip(window, pat, mask))


# Longest (offset + length) over every signature — one header read suffices.
MAX_MAGIC_SPAN = max(
    (off + len(pat)
     for sigs in EXTENSION_TABLE.values()
     for siglist in sigs.values()
     for off, pat, _m in siglist),
    default=0,
)


def verify_magic(category: str, ext: str, header: bytes) -> bool:
    """True if `header` carries one of the extension's magic signatures."""
    sigs = EXTENSION_TABLE[category].get(ext.lower())
    if not sigs:
        return False
    return any(_match_sig(header, s) for s in sigs)


def _read_header(path: str | os.PathLike) -> Optional[bytes]:
    try:
        with open(path, "rb") as f:
            return f.read(MAX_MAGIC_SPAN)
    except OSError:
        return None


def kind_for_extension(ext: str) -> ObjectKind:
    """Extension-only kind resolution (no file I/O, no conflict checks)."""
    cands = extension_candidates(ext)
    if not cands:
        return ObjectKind.UNKNOWN
    return CATEGORY_KIND[cands[0]]


def resolve_kind(
    path: str | os.PathLike,
    ext: Optional[str] = None,
    header: Optional[bytes] = None,
) -> ObjectKind:
    """Resolve a file's ObjectKind the way `Extension::resolve_conflicting`
    does (magic.rs:178-236): unambiguous extensions are trusted without I/O;
    the known cross-category conflicts (`ts`, `mts`: video vs code) read the
    header and fall back to code when video magic is absent.

    `header` lets batch pipelines (which already staged the first bytes of
    every file) avoid a second read.
    """
    if ext is None:
        name = os.path.basename(os.fspath(path))
        dot = name.rfind(".")
        ext = name[dot + 1:] if dot > 0 else ""
    if not ext:
        return ObjectKind.UNKNOWN
    cands = extension_candidates(ext)
    if not cands:
        return ObjectKind.UNKNOWN
    if len(cands) == 1:
        return CATEGORY_KIND[cands[0]]
    # Conflict path. The reference only disambiguates ts/mts (video|code);
    # any other conflict resolves to None → Unknown (magic.rs:222-234).
    if ext.lower() in ("ts", "mts") and "video" in cands:
        if header is None:
            header = _read_header(path)
        if header is not None and verify_magic("video", ext, header):
            return ObjectKind.VIDEO
        return ObjectKind.CODE
    return ObjectKind.UNKNOWN
