"""The torch port's serving slice against the JAX package, on the CPU:
a FixedKAN structured and saved by JAX is loaded, served over a real HTTP
socket and answered by the port; checkpoints cross in both directions.

Bar: atol 1e-5 against the JAX model's own output (the JAX suite's
serving bar).  The layers run 'fused_dw': f32 kernel semantics on both
sides, where only the summation order differs.
"""

import json
import subprocess
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from qkan_implementation_tpu.models import FixedKAN as JaxFixedKAN
from qkan_implementation_tpu.models import FixedKANConfig as JaxConfig
from qkan_implementation_tpu_torch.models import FixedKAN, FixedKANConfig
from qkan_implementation_tpu_torch.serving import BatchedPredictor, serve
from qkan_implementation_tpu_torch.utils import (
    params_from_numpy,
    params_to_numpy,
)

SHAPE = [6, 4, 3, 2]


@pytest.fixture(scope="module")
def jax_model(tmp_path_factory):
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (128, SHAPE[0]))
    y = np.stack([np.sin(2 * x[:, 0]) + 0.5 * x[:, 1] * x[:, 2],
                  x[:, 3] ** 2 - 0.3 * x[:, 4] + 0.1 * x[:, 5]], axis=1)
    kan = JaxFixedKAN(JaxConfig.preset(
        "recommended", SHAPE, 4, layer_backend="fused_dw"
    ))
    kan.optimize(jnp.asarray(x), jnp.asarray(y), solver="exact")
    path = str(tmp_path_factory.mktemp("jax") / "model.npz")
    kan.save_model(path)
    return kan, path


def _request(url, body=None):
    req = urllib.request.Request(
        url, data=body, headers={"Content-Type": "application/json"}
    )
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_jax_checkpoint_served_over_http_matches_jax(jax_model):
    kan, path = jax_model
    pred = BatchedPredictor(path, max_batch=64, device="cpu")
    pred.warmup()
    x = np.random.default_rng(1).uniform(-1, 1, (37, SHAPE[0]))
    want = np.asarray(kan(jnp.asarray(x)))
    server, thread = serve(pred, port=0, background=True)
    try:
        host, port = server.server_address
        base = f"http://{host}:{port}"
        code, health = _request(base + "/healthz")
        assert code == 200 and health["status"] == "ok"
        for rows in (1, 5, 37):
            code, body = _request(
                base + "/predict",
                json.dumps({"inputs": x[:rows].tolist()}).encode(),
            )
            assert code == 200
            np.testing.assert_allclose(
                np.asarray(body["outputs"]), want[:rows], atol=1e-5
            )
        code, health = _request(base + "/healthz")
        assert health["requests"] == 3 and health["latency_p99_ms"] > 0
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)


def test_port_checkpoint_loads_in_jax(jax_model, tmp_path):
    kan, path = jax_model
    port = FixedKAN.load_model(path, device="cpu")
    out = str(tmp_path / "port.npz")
    port.save_model(out)
    # the same arrays and config bytes as the JAX package writes
    a, b = np.load(path), np.load(out)
    assert sorted(a.files) == sorted(b.files)
    for key in a.files:
        assert a[key].dtype == b[key].dtype
        np.testing.assert_array_equal(a[key], b[key])
    back = JaxFixedKAN.load_model(out)
    assert back.config == kan.config
    x = np.random.default_rng(2).uniform(-1, 1, (9, SHAPE[0]))
    np.testing.assert_allclose(
        np.asarray(back(jnp.asarray(x))), np.asarray(kan(jnp.asarray(x))),
        atol=0, rtol=0,
    )
    np.testing.assert_allclose(
        port(x).numpy(), np.asarray(kan(jnp.asarray(x))), atol=1e-5
    )


def test_params_numpy_round_trip(jax_model):
    kan, _ = jax_model
    src = [{k: np.asarray(v) for k, v in lp.items()} for lp in kan.params]
    tensors = params_from_numpy(src, "cpu")
    assert [list(lp) for lp in tensors] == [list(lp) for lp in src]
    back = params_to_numpy(tensors)
    for a, b in zip(src, back):
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    f32 = params_from_numpy(src, "cpu", dtype=torch.float32)
    assert f32[0]["coefficients"].dtype == torch.float32
    assert f32[0]["degrees"].dtype == torch.int32  # integers keep theirs


def test_predictor_buckets_and_batch_limits(jax_model):
    kan, path = jax_model
    model = FixedKAN.load_model(path, device="cpu")
    pred = BatchedPredictor(model, max_batch=64)
    assert pred.buckets == [1, 2, 4, 8, 16, 32, 64]
    assert [pred._bucket_for(n) for n in (1, 3, 33, 64)] == [1, 4, 64, 64]
    with pytest.raises(ValueError, match="exceeds max_batch"):
        pred.predict(np.zeros((65, SHAPE[0])))
    with pytest.raises(ValueError, match="shape"):
        pred.predict(np.zeros((4, SHAPE[0] + 1)))
    one = pred.predict(np.zeros(SHAPE[0]))  # a 1-D input is one row
    assert one.shape == (1, 2)  # every layer maps to the target width

    odd = BatchedPredictor(model, max_batch=100)
    assert odd.buckets[-2:] == [64, 100]
    x = np.random.default_rng(3).uniform(-1, 1, (70, SHAPE[0]))
    out = odd.predict(x)  # terminal bucket: pad to 100, slice to 70
    assert out.shape == (70, 2)
    np.testing.assert_allclose(out, np.asarray(kan(jnp.asarray(x))),
                               atol=1e-5)
    for bad in (0, -4, 2.5):
        with pytest.raises(ValueError, match="max_batch"):
            BatchedPredictor(model, max_batch=bad)
    if not torch.cuda.is_available():
        # a path without a device means the card: never the CPU silently
        with pytest.raises(RuntimeError, match="is_available"):
            BatchedPredictor(path)
        with pytest.raises(RuntimeError, match="is_available"):
            FixedKAN.load_model(path)
    before = odd.stats()["requests"]
    for _ in range(3):
        odd.predict(x[:2])
    assert odd.stats()["requests"] == before + 3


def test_float64_predictor_keeps_float64(jax_model):
    _, path = jax_model
    cfg = json.loads(bytes(np.load(path)["config_json"]).decode())
    cfg["layer_backend"] = "xla"
    model = FixedKAN.load_model(path, device="cpu")
    model.config = FixedKANConfig(**cfg)
    pred = BatchedPredictor(model, max_batch=8, dtype=torch.float64)
    seen = {}
    forward = model.forward

    def spy(x):
        seen["dtype"] = x.dtype
        return forward(x)

    model.forward = spy
    out = pred.predict(np.full((1, SHAPE[0]), 0.1234567890123456))
    assert seen["dtype"] == torch.float64 and out.dtype == np.float64


def test_http_errors(jax_model):
    _, path = jax_model
    model = FixedKAN.load_model(path, device="cpu")
    pred = BatchedPredictor(model, max_batch=8)
    server, thread = serve(pred, port=0, background=True)
    try:
        host, port = server.server_address
        base = f"http://{host}:{port}"
        for body in (b'{"nope": 1}', b"not json",
                     b'{"inputs": [[1.0, 2.0]]}',
                     b'{"inputs": [[1, 2, 3, 4, 5, 6], [1]]}'):
            code, reply = _request(base + "/predict", body)
            assert code == 400, (body, reply)
        code, _ = _request(base + "/nowhere")
        assert code == 404
        # non-finite outputs are a server fault
        coeffs = model.params[0]["coefficients"].clone()
        coeffs[0, 0, 0, 0] = float("nan")
        params = model.params
        params[0]["coefficients"] = coeffs
        model.params = params
        code, reply = _request(
            base + "/predict", json.dumps({"inputs": [[0.1] * 6]}).encode()
        )
        assert code == 500 and "non-finite" in reply["error"]

        def fault(_):
            raise RuntimeError("device fault")

        pred.predict = fault
        code, reply = _request(
            base + "/predict", json.dumps({"inputs": [[0.1] * 6]}).encode()
        )
        assert code == 500 and "RuntimeError" in reply["error"]
        code, health = _request(base + "/healthz")
        assert code == 200
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "import qkan_implementation_tpu_torch\n"
        "import qkan_implementation_tpu_torch.models\n"
        "import qkan_implementation_tpu_torch.ops\n"
        "import qkan_implementation_tpu_torch.ops._cuda_build\n"
        "import qkan_implementation_tpu_torch.serving\n"
        "import qkan_implementation_tpu_torch.utils\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('qkan_implementation_tpu.')"
        " or m == 'qkan_implementation_tpu']\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
