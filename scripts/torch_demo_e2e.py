#!/usr/bin/env python
"""Manual end-to-end demo of the PyTorch port (the port of
scripts/demo_e2e.py; reference parity: test_season_search.py — a script
that exercises the real service stack, here fully offline).

Creates a small seasonal photo library, boots the port's HTTP server
(``python -m photo_search_engine_tpu_torch.api.app``) on a free port,
builds the index, and walks through every search mode: text,
season/time-of-day filters, image-to-image, upload-to-search, and the
rerank pipeline.  Prints a human-readable transcript.

Unlike the JAX demo it does not default ``PSE_PLATFORM`` to ``cpu``: the
server runs on the CUDA card unless the caller sets ``PSE_PLATFORM=cpu``.

Run:  python scripts/torch_demo_e2e.py
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import time
import urllib.request

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def _post(base, path, payload):
    request = urllib.request.Request(
        base + path,
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
        method="POST",
    )
    with urllib.request.urlopen(request, timeout=30) as response:
        return json.loads(response.read())


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=30) as response:
        return json.loads(response.read())


def _post_multipart(base, path, fields, file_field, filename, content):
    """Multipart POST (stdlib-only): the /search_by_uploaded_image contract
    (reference api/routes.py:290-382 reads request.files['image'] + form)."""
    boundary = "pse-demo-boundary-7e2f91c4"
    parts = []
    for key, value in fields.items():
        parts.append(
            f"--{boundary}\r\nContent-Disposition: form-data; "
            f'name="{key}"\r\n\r\n{value}\r\n'.encode()
        )
    parts.append(
        f"--{boundary}\r\nContent-Disposition: form-data; "
        f'name="{file_field}"; filename="{filename}"\r\n'
        "Content-Type: image/jpeg\r\n\r\n".encode()
    )
    parts.append(content)
    parts.append(f"\r\n--{boundary}--\r\n".encode())
    body = b"".join(parts)
    request = urllib.request.Request(
        base + path,
        data=body,
        headers={"Content-Type": f"multipart/form-data; boundary={boundary}"},
        method="POST",
    )
    with urllib.request.urlopen(request, timeout=30) as response:
        return json.loads(response.read())


def make_library(photo_dir: str) -> None:
    from PIL import Image

    specs = [
        ("beach_sunset_sea.jpg", "2023:07:15 18:30:00", (240, 170, 80)),
        ("beach_waves_surf.jpg", "2023:08:02 11:00:00", (90, 160, 220)),
        ("city_night_buildings.jpg", "2024:01:10 21:00:00", (20, 24, 60)),
        ("mountain_lake_snow.jpg", "2024:02:02 10:00:00", (235, 238, 248)),
        ("dog_grass_park.jpg", None, (70, 160, 70)),
        ("forest_trail_autumn.jpg", "2023:10:20 15:30:00", (150, 90, 30)),
    ]
    for name, stamp, color in specs:
        image = Image.new("RGB", (320, 240), color)
        path = os.path.join(photo_dir, name)
        if stamp:
            exif = Image.Exif()
            exif[306] = stamp
            image.save(path, exif=exif)
        else:
            image.save(path)


def server_command() -> list:
    """The port's app as a subprocess command."""
    return [sys.executable, "-m", "photo_search_engine_tpu_torch.api.app"]


def server_env(photo_dir: str, data_dir: str, port: int) -> dict:
    """The server's environment: this process's, with the library, the data
    directory and the port; ``PSE_PLATFORM`` stays what the caller set."""
    env = dict(os.environ)
    env.update(
        PHOTO_DIR=photo_dir,
        DATA_DIR=data_dir,
        RUNTIME_DATA_DIR=data_dir,
        EMBEDDING_DIMENSION="256",
        SERVER_PORT=str(port),
    )
    return env


def main() -> int:
    tmp = tempfile.mkdtemp(prefix="pse_demo_")
    photo_dir = os.path.join(tmp, "photos")
    data_dir = os.path.join(tmp, "data")
    os.makedirs(photo_dir)
    os.makedirs(data_dir)
    make_library(photo_dir)

    # pick a genuinely free port so we never talk to a stranger's service
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as probe:
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
    env = server_env(photo_dir, data_dir, port)
    # file-backed output: a PIPE would deadlock the server once its
    # unread output exceeds the OS pipe buffer on larger libraries
    log_path = os.path.join(tmp, "server.log")
    log_file = open(log_path, "w")
    server = subprocess.Popen(
        server_command(),
        env=env,
        stdout=log_file,
        stderr=subprocess.STDOUT,
        cwd=os.path.join(os.path.dirname(__file__), ".."),
    )
    base = f"http://127.0.0.1:{port}"
    print(f"server: {base} (log: {log_path})")
    try:
        for _ in range(60):
            try:
                _get(base, "/index_status")
                break
            except Exception:
                time.sleep(0.5)
        print("== building index ==")
        print(_post(base, "/init_index", {"mode": "full"})["message"])
        # up to 10 min: the first build on the card compiles the kernels
        # with nvcc when they are not built yet (terminal states break early)
        for _ in range(2400):
            status = _get(base, "/index_status")
            if status["status"] in {"success", "ready", "failed"}:
                break
            time.sleep(0.25)
        print(f"index: {status['status']} {status['indexed_count']}/{status['total_count']} "
              f"exif_coverage={status.get('exif_coverage')}")

        def show(label, payload):
            print(f"\n== {label} ==")
            if payload.get("status") != "success":
                print("ERROR:", payload.get("message"))
                return
            for hit in payload["results"][:3]:
                print(f"  #{hit['rank']} {hit['file_name']}  score={hit['score']}")
            rounds = payload.get("search_debug", {}).get("rounds", [])
            if rounds:
                print(f"  planner: {[r['round'] for r in rounds]}"
                      f" reason={rounds[0].get('reason') or '-'}")

        show("text: beach sunset", _post(base, "/search_photos",
             {"query": "beach sunset sea", "top_k": 3}))
        show("season filter: 夏天的照片", _post(base, "/search_photos",
             {"query": "夏天的照片", "top_k": 6}))
        show("season+period: 冬天上午", _post(base, "/search_photos",
             {"query": "冬天上午的照片", "top_k": 6}))
        show("autumn date range: 2023年10月", _post(base, "/search_photos",
             {"query": "2023年10月的照片", "top_k": 6}))
        show("image-to-image (beach_sunset_sea)", _post(base, "/search_by_image",
             {"image_path": os.path.join(photo_dir, "beach_sunset_sea.jpg"),
              "top_k": 3, "enable_visual_rerank": True}))
        # upload-to-search: a FRESH image (not in the library) goes up as
        # multipart/form-data, exactly like the SPA's upload tab
        from io import BytesIO

        from PIL import Image

        upload = Image.new("RGB", (320, 240), (235, 165, 85))  # sunset-ish
        buffer = BytesIO()
        upload.save(buffer, format="JPEG")
        show("upload-to-search (fresh sunset-toned jpeg)", _post_multipart(
            base, "/search_by_uploaded_image",
            {"top_k": "3", "enable_visual_rerank": "true"},
            "image", "fresh_sunset_upload.jpg", buffer.getvalue()))
        print("\nall demo flows completed")
        return 0
    finally:
        server.terminate()
        try:
            server.wait(timeout=5)
        except subprocess.TimeoutExpired:
            server.kill()
        log_file.close()


if __name__ == "__main__":
    raise SystemExit(main())
