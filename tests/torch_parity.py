"""Shared helpers of the ``test_torch_*`` parity tests: seeded inputs made
with numpy and handed to both packages, the top-k comparison, and the
route flow both apps run.  Imports no jax (a test runs it with jax absent)."""

from __future__ import annotations

import io
import os
import time

import numpy as np


def unit_rows(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def as_bf16_values(x):
    """float32 array holding ``x`` rounded to bfloat16 (exact in f32), so
    both packages start from the same bf16 values."""
    import torch

    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16).float().numpy()


def _host(x):
    """numpy view of a numpy array, a jax array or a torch tensor on any device."""
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def assert_topk_match(got_v, got_i, ref_v, ref_i, *, tol, descending=True, cut=None, exact=False):
    """The top-k comparison rule of the port's tests and of ``chip_smoke.py``.

    Values within ``tol``; indices equal wherever the reference score of
    the slot differs from its neighbours by more than ``tol``.  ``cut`` is
    the reference's (k+1)-th score per row (None: the last slot counts as
    isolated from below).  Empty slots (±inf, index -1 or INT_MAX) must
    agree exactly.  ``exact`` asks for identical values and indices in
    every slot.  Returns the largest value error."""
    got_v, ref_v = _host(got_v).astype(np.float64), _host(ref_v).astype(np.float64)
    got_i, ref_i = _host(got_i), _host(ref_i)
    assert got_v.shape == ref_v.shape and got_i.shape == ref_i.shape, (got_v.shape, ref_v.shape)
    tol = 0.0 if exact else tol
    finite = np.isfinite(ref_v)
    np.testing.assert_array_equal(np.isfinite(got_v), finite)
    np.testing.assert_array_equal(got_v[~finite], ref_v[~finite])
    np.testing.assert_allclose(got_v[finite], ref_v[finite], rtol=0, atol=tol)
    s = ref_v if descending else -ref_v
    inf = np.full(s.shape[:-1] + (1,), np.inf)
    after = -inf if cut is None else (_host(cut).astype(np.float64) * (1 if descending else -1))[..., None]
    prev = np.concatenate([inf, s[..., :-1]], axis=-1)
    nxt = np.concatenate([s[..., 1:], after], axis=-1)
    with np.errstate(invalid="ignore"):
        isolated = (np.abs(prev - s) > tol) & (np.abs(s - nxt) > tol)
    must = np.ones_like(finite) if exact else isolated | ~finite
    np.testing.assert_array_equal(got_i[must], ref_i[must])
    return float(np.abs(got_v[finite] - ref_v[finite]).max(initial=0.0))


def _upload_bytes():
    from PIL import Image

    buf = io.BytesIO()
    Image.new("RGB", (320, 240), (235, 165, 85)).save(buf, format="JPEG")
    return buf.getvalue()


def run_flow(client, photo_dir):
    """Build the index through the routes, then the five searches."""
    assert client.post("/init_index", json_body={"mode": "full"}).status_code == 200
    deadline = time.time() + 60
    while time.time() < deadline:
        status = client.get("/index_status").get_json()
        if status["status"] in {"success", "ready", "failed"}:
            break
        time.sleep(0.05)
    assert status["status"] in {"success", "ready"}, status
    out = {"status": {k: status[k] for k in ("status", "indexed_count", "total_count")}}
    out["text"] = client.post("/search_photos", json_body={"query": "beach sunset sea", "top_k": 3}).get_json()
    out["season"] = client.post("/search_photos", json_body={"query": "夏天的照片", "top_k": 6}).get_json()
    # search text plus a season: without a keyword index this is the masked
    # vector search (the grouped scan under the micro-batcher)
    out["season_text"] = client.post("/search_photos", json_body={"query": "夏天 海边", "top_k": 6}).get_json()
    out["image"] = client.post(
        "/search_by_image", json_body={"image_path": os.path.join(photo_dir, "beach_sunset_sea.jpg"), "top_k": 3}
    ).get_json()
    out["upload"] = client.post(
        "/search_by_uploaded_image", data={"top_k": "3"}, files={"image": ("fresh.jpg", _upload_bytes())}
    ).get_json()
    for name in ("text", "season", "image", "upload"):
        assert out[name]["status"] == "success" and out[name]["results"], (name, out[name])
    # the keyword channel's relevance floors may rightly leave this one empty
    assert out["season_text"]["status"] == "success", out["season_text"]
    return out
