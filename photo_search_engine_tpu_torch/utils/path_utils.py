"""Cross-OS (Windows ⇄ WSL ⇄ POSIX) path handling.

Behavior-parity target: reference utils/path_utils.py:1-90 — drive-letter ⇄
/mnt/<drive> conversion, os-aware normalization, display-path preference for
Windows style, file-manager open, case-insensitive comparison.
"""

from __future__ import annotations

import ntpath
import os
import posixpath
import re
import subprocess
from pathlib import Path

_WIN_DRIVE = re.compile(r"^(?P<drive>[A-Za-z]):[\\/](?P<rest>.*)$")
_WSL_MOUNT = re.compile(r"^/mnt/(?P<drive>[a-zA-Z])/(?P<rest>.*)$")


def windows_to_wsl_path(path: str) -> str:
    """``C:\\a\\b`` → ``/mnt/c/a/b`` (reference path_utils.py:24-30)."""
    m = _WIN_DRIVE.match(path or "")
    if not m:
        return path
    return "/mnt/%s/%s" % (m.group("drive").lower(), m.group("rest").replace("\\", "/"))


def wsl_to_windows_path(path: str) -> str:
    """``/mnt/c/a/b`` → ``C:\\a\\b`` (reference path_utils.py:33-39)."""
    m = _WSL_MOUNT.match(path or "")
    if not m:
        return path
    return "%s:\\%s" % (m.group("drive").upper(), m.group("rest").replace("/", "\\"))


def normalize_local_path(path: str) -> str:
    """Strip quotes, convert across Windows/WSL styles for the current OS,
    and absolutize (reference path_utils.py:42-58)."""
    if not path:
        return ""
    # fast path: a clean absolute POSIX path outside the WSL mount tree is
    # its own normalization — the searcher normalizes every candidate path
    # several times per request, and the regex+abspath walk below was the
    # single hottest stack-profile entry at 1M rows (~2k calls/request)
    if (
        os.name != "nt"
        and path[0] == "/"
        and not path[-1].isspace()
        and path[-1] not in "\"'/"
        and "\\" not in path
        and "//" not in path
        and not path.startswith("/mnt/")
        and "/./" not in path
        and "/../" not in path
        and not path.endswith(("/.", "/.."))
    ):
        return path
    candidate = path.strip().strip('"').strip("'")
    if _WIN_DRIVE.match(candidate):
        if os.name == "nt":
            return ntpath.abspath(candidate.replace("/", "\\"))
        return posixpath.abspath(windows_to_wsl_path(candidate).replace("\\", "/"))
    if _WSL_MOUNT.match(candidate):
        if os.name == "nt":
            return ntpath.abspath(wsl_to_windows_path(candidate).replace("/", "\\"))
        return posixpath.abspath(candidate.replace("\\", "/"))
    return os.path.abspath(os.path.expanduser(candidate))


def path_normalization_is_state_free(path: str) -> bool:
    """True when ``normalize_local_path(path)`` cannot depend on live
    process state (CWD / HOME): absolute POSIX, Windows-drive, or
    WSL-mount forms.  Relative and ``~`` paths absolutize against the
    CWD/HOME *at call time* (``os.path.abspath``/``expanduser`` above),
    so their normalizations must never be memoized across requests."""
    candidate = (path or "").strip().strip('"').strip("'")
    if not candidate:
        return True  # "" normalizes to "" unconditionally
    if candidate.startswith("~"):
        return False
    if _WIN_DRIVE.match(candidate) or _WSL_MOUNT.match(candidate):
        return True
    if os.name == "nt":
        return ntpath.isabs(candidate)
    return candidate.startswith("/")


def ensure_display_path(path: str) -> str:
    """Prefer Windows-style display when the path lives under a WSL mount
    (reference path_utils.py:61-66)."""
    if not path:
        return ""
    normalized = normalize_local_path(path)
    windows_variant = wsl_to_windows_path(normalized)
    return windows_variant if windows_variant != normalized else normalized


def open_in_file_manager(path: str) -> None:
    """Open the containing folder (explorer.exe /select on Windows/WSL,
    xdg-open elsewhere; reference path_utils.py:69-85)."""
    normalized = normalize_local_path(path)
    if not os.path.exists(normalized):
        raise FileNotFoundError(f"File does not exist: {path}")
    windows_path = wsl_to_windows_path(normalized)
    if windows_path != normalized:
        subprocess.run(["explorer.exe", f"/select,{windows_path}"], check=False, timeout=10)
        return
    if os.name == "nt":
        subprocess.run(["explorer", f"/select,{normalized}"], check=False, timeout=10)
        return
    subprocess.run(["xdg-open", str(Path(normalized).parent)], check=False, timeout=10)


def same_file_path(left: str, right: str) -> bool:
    """Case-insensitive normalized comparison (reference path_utils.py:87-90)."""
    return os.path.normcase(normalize_local_path(left)) == os.path.normcase(
        normalize_local_path(right)
    )
