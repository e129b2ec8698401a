"""The port's ``/serving`` page in a process that never loaded the serving
plane (brpc_tpu_torch/builtin/services.py's ``serving_service``).

No engine can run in a process that has not imported the engine module,
so the page answers the JAX package's empty-engine output there without
importing ``brpc_tpu_torch.serving.engine``, and so without loading torch
inside a scrape: the import took over a second, past a fleet observer's
3 s fetch limit under load. In a fresh interpreter a Server answers both
forms of the page, a fleet observer's scrape succeeds, and neither module
is loaded after; with an engine running the page still lists it.
"""

import json
import os
import subprocess
import sys

from brpc_tpu_torch.policy.http_protocol import http_fetch
from brpc_tpu_torch.rpc import Server
from brpc_tpu_torch.serving import (EngineConfig, KVCacheConfig,
                                    ModelConfig, PagedKVCache,
                                    ServingEngine, TinyTransformer)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JAX package's page with no engine (brpc_tpu/builtin/services.py)
EMPTY_JSON = json.dumps({"engines": []}, indent=2) + "\n"
EMPTY_TEXT = "no serving engine running\n"

FRESH = """
import json, sys
from brpc_tpu_torch.fleet import FleetObserver
from brpc_tpu_torch.policy.http_protocol import http_fetch
from brpc_tpu_torch.rpc import Server
srv = Server().start('127.0.0.1:0')
ep = str(srv.listen_endpoint())
pages = {p: http_fetch(ep, 'GET', p, timeout=3.0)
         for p in ('/serving?format=json', '/serving')}
obs = FleetObserver([ep])
scraped = obs.scrape_once()
obs.hide_all()
srv.stop()
srv.join()
print(json.dumps({
    'pages': {p: [r.status, r.body.decode()] for p, r in pages.items()},
    'scraped': scraped,
    'loaded': [m for m in ('torch', 'brpc_tpu_torch.serving',
                           'brpc_tpu_torch.serving.engine')
               if m in sys.modules]}))
"""


def _fresh():
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", FRESH], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_the_page_answers_without_loading_the_serving_plane():
    got = _fresh()
    assert got["pages"] == {"/serving?format=json": [200, EMPTY_JSON],
                            "/serving": [200, EMPTY_TEXT]}
    assert got["scraped"] == 1
    assert got["loaded"] == []


def test_the_page_lists_a_running_engine():
    cfg = ModelConfig(vocab=64, d_model=16, n_heads=2, n_layers=1)
    kv = PagedKVCache(KVCacheConfig(16, 16), cfg.n_layers, cfg.kv_dim,
                      device="cpu")
    model = TinyTransformer(cfg, kv)
    srv = Server().start("127.0.0.1:0")
    ep = str(srv.listen_endpoint())

    def engines():
        return json.loads(http_fetch(ep, "GET", "/serving?format=json",
                                     timeout=30).body)["engines"]

    try:
        before = len(engines())
        engine = ServingEngine(model, kv, EngineConfig(max_batch=2)).start()
        try:
            listed = engines()
            text = http_fetch(ep, "GET", "/serving", timeout=30).body
        finally:
            engine.stop()
        after = len(engines())
    finally:
        srv.stop()
        srv.join()
        kv.assert_idle()
        model.close()
    assert len(listed) == before + 1 and after == before
    assert any(e["max_batch"] == 2 and e["kv"]["blocks_total"] == 16
               for e in listed), listed
    assert b"[engine " in text and b"max_batch=2" in text
