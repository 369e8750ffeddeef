"""The SPA contract of ``tests/test_spa_contract.py`` on the port: its copy
of ``api/spa_contract.py`` against its copy of ``templates/index.html``
(every mirrored DOM id once, every mirrored JS expression, the poll
interval), and the mirrors driven with live payloads of the port's app
(a background index build polled to its end, a search rendered through
the planner and results mirrors), each rendered the same by the JAX
package's mirrors."""

import os
import re
import sys
import time

import pytest

from photo_search_engine_tpu.api import spa_contract as jax_spa
from photo_search_engine_tpu_torch.api import spa_contract
from photo_search_engine_tpu_torch.api.app import create_app, initialize_services, load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAGE = os.path.join(REPO, "photo_search_engine_tpu_torch", "templates", "index.html")
sys.path.insert(0, os.path.join(REPO, "scripts"))
from demo_e2e import make_library  # noqa: E402  (stdlib + PIL only)


@pytest.fixture(scope="module")
def page():
    with open(PAGE, encoding="utf-8") as f:
        return f.read()


@pytest.mark.parametrize("dom_id", spa_contract.REQUIRED_DOM_IDS)
def test_every_mirrored_dom_id_exists_once(page, dom_id):
    assert len(re.findall(f'id="{re.escape(dom_id)}"', page)) == 1, dom_id


@pytest.mark.parametrize("expr", spa_contract.REQUIRED_JS_EXPRESSIONS)
def test_every_mirrored_js_expression_present(page, expr):
    assert expr in page


def test_poll_interval_pinned(page):
    assert f"setInterval(pollStatus, {spa_contract.POLL_INTERVAL_MS})" in page
    assert (spa_contract.POLL_INTERVAL_MS, spa_contract.REQUIRED_DOM_IDS, spa_contract.REQUIRED_JS_EXPRESSIONS) == (
        jax_spa.POLL_INTERVAL_MS, jax_spa.REQUIRED_DOM_IDS, jax_spa.REQUIRED_JS_EXPRESSIONS)


@pytest.fixture()
def client(tmp_path):
    photo_dir = tmp_path / "photos"
    photo_dir.mkdir()
    make_library(str(photo_dir))
    config = load_config({"PHOTO_DIR": str(photo_dir), "DATA_DIR": str(tmp_path / "data"),
                          "RUNTIME_DATA_DIR": str(tmp_path / "data"), "EMBEDDING_DIMENSION": "64",
                          "PSE_PLATFORM": "cpu", "SEARCH_MICROBATCH_ENABLED": "0", "INDEX_BACKGROUND_MODE": "thread"})
    return create_app(initialize_services(config)).test_client()


def _both(render, payload):
    """The port's mirror's rendering, which must be the JAX mirror's."""
    got = getattr(spa_contract, render)(payload)
    assert got == getattr(jax_spa, render)(payload), render
    return got


def test_polling_state_machine_over_live_build(client):
    response = client.post("/init_index", json_body={"mode": "full"})
    assert response.status_code == 200
    first = response.get_json()
    polling = spa_contract.poll_transition(first["status"], False)
    rendered_states = []
    deadline = time.time() + 60
    status = first
    while time.time() < deadline:
        status = client.get("/index_status").get_json()
        rendered = _both("render_status", status)
        rendered_states.append((status["status"], rendered))
        polling = spa_contract.poll_transition(status["status"], polling)
        if status["status"] == "processing":
            assert rendered["buttons_disabled"]
        if status["status"] in {"success", "ready", "failed"}:
            break
        time.sleep(0.05)
    assert status["status"] in {"success", "ready"}
    assert not polling, "polling must stop once the build ends"
    final = rendered_states[-1][1]
    assert final["pill_class"] == status["status"] and final["progress_hidden"] and not final["buttons_disabled"]
    assert f"{status['indexed_count']}/{status['total_count']}" in final["text"]


def test_processing_payload_renders_progress():
    rendered = _both("render_status", {
        "status": "processing", "message": "索引构建中", "total_count": 10, "indexed_count": 3,
        "failed_count": 1, "fallback_ratio": 0.25,
    })
    assert not rendered["progress_hidden"] and abs(rendered["progress_value"] - 40.0) < 1e-9
    assert "3/10 张" in rendered["text"] and "失败 1" in rendered["text"] and "降级率 25.0%" in rendered["text"]
    assert rendered["buttons_disabled"]


def test_planner_panel_renders_live_rounds(client):
    client.post("/init_index", json_body={"mode": "full"})
    deadline = time.time() + 60
    while time.time() < deadline and client.get("/index_status").get_json()["status"] not in {"success", "ready"}:
        time.sleep(0.05)
    payload = client.post("/search_photos", json_body={"query": "beach sunset", "top_k": 3}).get_json()
    assert payload["status"] == "success"
    planner = _both("render_planner", payload.get("search_debug"))
    assert not planner["hidden"] and planner["rounds"]
    for line in planner["rounds"]:
        assert "个结果 · top" in line and "search_text:" in line
    results = _both("render_results", payload)
    assert results["title"] == f"结果（{payload['total_results']}）"
    assert len(results["cards"]) == len(payload["results"])
    for card, hit in zip(results["cards"], payload["results"]):
        assert card["rank"] == hit["rank"] and card["img"].startswith("/photo?") and "score " in card["score_line"]


def test_planner_hidden_without_debug():
    assert _both("render_planner", None)["hidden"] and _both("render_planner", {})["hidden"]
