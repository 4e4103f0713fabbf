"""The service layer, PyTorch port vs the JAX package on the CPU.

The payload codec writes the JAX codec's JSON text; the job manager keeps
its DAG, timeout and error semantics; the port's stdlib server and the
JAX package's aiohttp server speak one protocol, each answering the
other's client; and the five services and the orchestrator run on the
small-weights rig (tests/torch_port_rig.py) at 3 timesteps, with tiny
ZoeDepth, LaMa and CLIP segmenters on the same weights in both packages:
a request served over HTTP gives the bits of the same call made in the
process, and the port's pipeline follows the JAX pipeline within the
rig's tolerances (the estimators' 1e-3 of depth feeds the inversion).

Every port server binds port 0 (a free port); a JAX server is handed a
port the OS just gave out, since its aiohttp site does not report the
one it bound.
"""

import copy
import io
import json
import socket
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionhandles_tpu.models import clip_image as jclip
from diffusionhandles_tpu.models import clip_text as jtext
from diffusionhandles_tpu.models import lama as jlama
from diffusionhandles_tpu.models import segmenter as jseg
from diffusionhandles_tpu.models import zoedepth as jzoe
from diffusionhandles_tpu.geometry import mesh as jmesh
from diffusionhandles_tpu.geometry import mesh_io as jio
from diffusionhandles_tpu.service import base as jbase
from diffusionhandles_tpu.service import client as jclient
from diffusionhandles_tpu.service import pipeline_app as japp
from diffusionhandles_tpu.service import services as jsvc
from diffusionhandles_tpu_torch.checkpoint import load_identity, to_nchw
from diffusionhandles_tpu_torch.geometry import mesh as tmesh
from diffusionhandles_tpu_torch.models import clip_image as tclip
from diffusionhandles_tpu_torch.models import clip_text as ttext
from diffusionhandles_tpu_torch.models import lama as tlama
from diffusionhandles_tpu_torch.models import segmenter as tseg
from diffusionhandles_tpu_torch.models import zoedepth as tzoe
from diffusionhandles_tpu_torch.models.weights import clip_state_dict
from diffusionhandles_tpu_torch.models.weights_clip import \
    clip_vision_state_dict
from diffusionhandles_tpu_torch.models.weights_lama import lama_state_dict
from diffusionhandles_tpu_torch.models.weights_zoedepth import \
    zoedepth_state_dict
from diffusionhandles_tpu_torch.service import base as tbase
from diffusionhandles_tpu_torch.service import client as tclient
from diffusionhandles_tpu_torch.service import job_manager as tjm
from diffusionhandles_tpu_torch.service import pipeline_app as tapp
from diffusionhandles_tpu_torch.service import run as trun
from diffusionhandles_tpu_torch.service import services as tsvc
from torch_port_rig import torch_on_one_thread  # noqa: F401
from torch_port_rig import (PROMPT, close, make_rig, np_,
                            random_flax_params, with_guided)

aiohttp = pytest.importorskip("aiohttp")

# the estimators' parity tolerances (tests/test_torch_port_aux.py)
ZOE_RTOL, ZOE_ATOL = 1e-3, 1e-4
LAMA_ATOL = 2e-5
# the inversion and the edit on depths that agree to ZOE_RTOL: the rig's
# own tolerances (tests/test_torch_port_pipeline.py) for equal inputs
# hold the identity and the edit only this far
IDENTITY_RTOL = 2e-2
EDIT_RTOL = 2e-2
# the previews on one state: the disparity as the pc transform's parity
# test holds it; the rgb render within RGB_ATOL (the two depth_to_mesh
# lifts differ by up to 2 ulps, which moves a pixel's barycentrics by a
# few 1e-6) but at pixels whose face differs (a near-tie the lifts move),
# at most RGB_FLIPS of them
DISPARITY_RTOL = 1e-5
RGB_ATOL = 1e-5
RGB_FLIPS = 0.01
EDIT = dict(rot_angle=10.0, rot_axis=(0.0, 1.0, 0.0),
            translation=(0.02, 0.0, 0.0))
FG_PROMPT = "a toy cube"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_jax(app_cls, *args, **kwargs) -> str:
    port = _free_port()
    app_cls(*args, port=port, **kwargs).start_background()
    url = f"http://127.0.0.1:{port}"
    assert jclient.ServiceClient(url).wait_healthy(timeout=30, poll=0.05)
    return url


def _start_port(app) -> str:
    app.start_background()
    return f"http://127.0.0.1:{app.port}"


# ---------------------------------------------------------------------------
# The codec and the job manager
# ---------------------------------------------------------------------------

def _payload():
    rng = np.random.RandomState(0)
    return {
        "img": rng.rand(2, 3, 4).astype(np.float32),
        "ids": np.arange(5, dtype=np.int64),
        "mask": rng.rand(1, 1, 3, 3) > 0.5,
        "half": rng.rand(3).astype(np.float16),
        "strided": rng.rand(4, 6).astype(np.float32)[:, ::2],
        "blob": b"\x00\x01binary",
        "nested": {"x": 1.5, "list": [np.float32(2.0), "s", np.int64(7)],
                   "tuple": (1, np.arange(3, dtype=np.uint8)), "none": None},
        "flag": True,
    }


def test_codec_json_text_matches_jax():
    payload = _payload()
    text = json.dumps(tbase.encode_payload(payload))
    assert text == json.dumps(jbase.encode_payload(payload))
    for decode in (tbase.decode_payload, jbase.decode_payload):
        back = decode(json.loads(text))
        for k in ("img", "ids", "mask", "half", "strided"):
            np.testing.assert_array_equal(back[k], payload[k])
            assert back[k].dtype == payload[k].dtype
        assert back["blob"] == payload["blob"]
        assert back["nested"]["list"] == [2.0, "s", 7]
    assert tbase.decode_payload(json.loads(text))["nested"]["tuple"][
        1].tolist() == [0, 1, 2]


def test_codec_refuses_tensors():
    """A tensor does not cross the wire: encode_payload raises, also
    nested, where the JAX codec passes an unknown object through."""
    for obj in (torch.ones(2), {"a": [1, {"b": torch.zeros(1)}]}):
        with pytest.raises(TypeError, match="tensor"):
            tbase.encode_payload(obj)


def test_job_manager_dag_ordering():
    order = []
    jm = tjm.JobManager(poll_interval=0.01)
    a = tjm.Job(lambda: order.append("a") or "A")
    b = tjm.Job(lambda: (time.sleep(0.05), order.append("b"))[0] or "B")
    jm.add_job(a)
    jm.add_job(b)

    def after_both(ja, jb):
        order.append("after")
        assert (ja.outputs(), jb.outputs()) == ("A", "B")
        jm.add_job(tjm.Job(lambda: order.append("chained")))

    jm.add_callback([a, b], after_both)
    jm.run()
    assert order.index("after") > max(order.index("a"), order.index("b"))
    assert order[-1] == "chained"


def test_job_manager_timeout_and_exceptions():
    jm = tjm.JobManager(poll_interval=0.01)
    jm.add_job(tjm.Job(lambda: time.sleep(2), timeout=0.05))
    with pytest.raises(TimeoutError, match="0.05"):
        jm.run()
    jm.shutdown()

    def boom():
        raise ValueError("kaboom")

    jm = tjm.JobManager(poll_interval=0.01)
    jm.add_job(tjm.Job(boom))
    with pytest.raises(ValueError, match="kaboom"):
        jm.run()


# ---------------------------------------------------------------------------
# One protocol: stdlib server and aiohttp server, either client
# ---------------------------------------------------------------------------

INDEX = "<html><body>ui</body></html>"


def _echo_app(base, calls, **kwargs):
    class Echo(base.Webapp):
        index_html = INDEX

        def __init__(self, **kw):
            super().__init__(**kw)
            self.route("echo", lambda req: {"got": req})

            def boom(req):
                calls.append(1)
                raise ValueError("bad input shape (7,)")
            self.route("boom", boom)
    return Echo(**kwargs)


@pytest.fixture(scope="module")
def echo_servers():
    """An echo service of each package under one netpath; yields
    {package: (url, handler-error calls)}."""
    t_calls, j_calls = [], []
    t_app = _echo_app(tbase, t_calls, port=0, netpath="/api")
    t_app.start_background()
    port = _free_port()
    _echo_app(jbase, j_calls, port=port, netpath="/api").start_background()
    urls = {"port": f"http://127.0.0.1:{t_app.port}",
            "jax": f"http://127.0.0.1:{port}"}
    assert jclient.ServiceClient(urls["jax"] + "/api").wait_healthy(30, 0.05)
    yield {"port": (urls["port"], t_calls), "jax": (urls["jax"], j_calls)}
    t_app.shutdown()


@pytest.mark.parametrize("server,client", [("port", jclient),
                                           ("jax", tclient)],
                         ids=["port_server_jax_client",
                              "jax_server_port_client"])
def test_transport_both_ways(echo_servers, server, client):
    """Health, an echo of arrays and bytes (a body of 8 MB among them), a
    handler error raised with its message and not retried, and GET / and
    /health."""
    url, calls = echo_servers[server]
    c = client.ServiceClient(url + "/api", retries=2, retry_backoff=0.01)
    assert c.wait_healthy(timeout=10, poll=0.05)
    payload = {k: v for k, v in _payload().items() if k != "nested"}
    payload["big"] = np.random.RandomState(1).rand(1 << 20)
    got = c.call("echo", **payload)["got"]
    for k, v in payload.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(got[k], v)
        else:
            assert got[k] == v
    calls.clear()
    with pytest.raises(RuntimeError, match="bad input shape"):
        c.call("boom", x=1)
    assert len(calls) == 1
    with urllib.request.urlopen(url + "/api/") as resp:
        assert resp.status == 200 and resp.read().decode() == INDEX
        assert resp.headers["Content-Type"].startswith("text/html")
    with urllib.request.urlopen(url + "/api/health") as resp:
        body = json.loads(resp.read())
    assert body == {"ok": True, "data": {"status": "ok", "service": "Echo"}}


def _raw(url, path, body=None):
    req = urllib.request.Request(url + path, data=body, headers={
        "Content-Type": "application/json"} if body is not None else {})
    try:
        with urllib.request.urlopen(req) as resp:
            return resp.status, resp.headers["Content-Type"], resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.headers["Content-Type"], exc.read()


def test_servers_answer_alike(echo_servers):
    """The same raw requests get the same status, content type and body
    from both servers (a failed handler's traceback aside, which names
    each package's files)."""
    t_url, j_url = echo_servers["port"][0], echo_servers["jax"][0]
    body = json.dumps(jbase.encode_payload(
        {"a": np.arange(6.0).reshape(2, 3), "b": b"xyz"})).encode()
    for path, data in (("/api/echo", body), ("/api/echo", b""),
                       ("/api/health", b"{}"), ("/api/health", None),
                       ("/api/", None), ("/api", None)):
        assert _raw(t_url, path, data) == _raw(j_url, path, data), path
    for path, data in (("/api/boom", b"{}"), ("/api/echo", b"{not json")):
        t, j = _raw(t_url, path, data), _raw(j_url, path, data)
        assert t[:2] == j[:2] and t[0] == 500
        tb, jb = json.loads(t[2]), json.loads(j[2])
        assert tb["ok"] is jb["ok"] is False and tb["error"] == jb["error"]
        assert "Traceback" in tb["traceback"]
    for path, data in (("/nope", None), ("/api/nope", b"{}")):
        assert _raw(t_url, path, data)[0] == _raw(j_url, path, data)[0] \
            == 404


def test_handlers_run_in_the_serving_threads_torch_state():
    """A handler runs with the grad mode of the thread that started
    serving, one request at a time, and a tensor in its result is a
    handler error."""
    seen, active = [], []

    def probe(req):
        active.append(1)
        seen.append((torch.is_grad_enabled(), len(active)))
        time.sleep(0.02)
        active.pop()
        return {}

    apps = []
    for grad in (False, True):
        app = tbase.Webapp(port=0)
        app.route("probe", probe)
        app.route("tensor", lambda req: {"x": torch.ones(1)})
        with torch.set_grad_enabled(grad):
            _start_port(app)
        apps.append(app)
        c = tclient.ServiceClient(f"http://127.0.0.1:{app.port}")
        threads = [threading.Thread(target=c.call, args=("probe",))
                   for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
        assert seen == [(grad, 1)] * 4
        seen.clear()
        with pytest.raises(RuntimeError, match="tensor"):
            c.call("tensor")
    assert apps[0].port != apps[1].port and 0 not in (a.port for a in apps)
    assert apps[1].last_request["route"] == "probe"
    for app in apps:
        app.shutdown()


def test_pipeline_ui_is_the_jax_page():
    from diffusionhandles_tpu.service.ui import PIPELINE_UI_HTML as jpage
    from diffusionhandles_tpu_torch.service.ui import PIPELINE_UI_HTML
    assert PIPELINE_UI_HTML == jpage


def test_object_peeling_sends_the_jax_request():
    """ObjectPeelingRemover posts the JAX remover's body (the mask
    dilated as there) to a REST endpoint answering {bg_img} and returns
    that image; without an endpoint it raises."""
    import http.server
    from diffusionhandles_tpu.service.object_peeling import \
        ObjectPeelingRemover as JRemover
    from diffusionhandles_tpu_torch.service.object_peeling import \
        ObjectPeelingRemover
    bodies = []

    class Peel(http.server.BaseHTTPRequestHandler):
        def do_POST(self):  # noqa: N802
            body = self.rfile.read(int(self.headers["Content-Length"]))
            bodies.append(body)
            req = tbase.decode_payload(json.loads(body))
            reply = json.dumps(tbase.encode_payload(
                {"bg_img": req["img"] * 0.5})).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(reply)))
            self.end_headers()
            self.wfile.write(reply)

        def log_message(self, *args):
            pass

    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Peel)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{server.server_address[1]}/peel"
    rng = np.random.RandomState(4)
    img = rng.rand(1, 3, 16, 16).astype(np.float32)
    mask = np.zeros((1, 1, 16, 16), np.float32)
    mask[..., 5:9, 6:10] = 1.0
    try:
        for dilation in (0, 2):
            out = ObjectPeelingRemover(url).remove_foreground(img, mask,
                                                              dilation)
            JRemover(url).remove_foreground(img, mask, dilation)
            assert bodies[-2] == bodies[-1]
            np.testing.assert_array_equal(out, img * 0.5)
        assert bodies[0] != bodies[2]  # the dilated mask
    finally:
        server.shutdown()
        server.server_close()
    with pytest.raises(RuntimeError, match="endpoint_url"):
        ObjectPeelingRemover().remove_foreground(img, mask)


# ---------------------------------------------------------------------------
# The services and the orchestrator on the rig
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rig():
    return make_rig(num_timesteps=3, guidance_max_step=2, num_optsteps=1)


def _models():
    """Tiny ZoeDepth, LaMa and CLIP segmenter of each package on the same
    weights: {package: (estimator, remover, selector)}."""
    rng = np.random.RandomState(0)
    perturb = lambda tree: jax.tree.map(lambda a: np.asarray(a) + (
        rng.randn(*a.shape) * 0.02).astype(np.float32), tree)
    zcfg = jzoe.tiny_zoedepth_config()
    zp = perturb(jax.jit(jzoe.ZoeDepthModel(zcfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3), jnp.float32)))
    lcfg = jlama.tiny_lama_config()
    lv = jax.jit(jlama.LamaGenerator(lcfg).init)(
        jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 4), jnp.float32))
    lv = {"params": perturb(lv["params"]), "batch_stats": lv["batch_stats"]}
    icfg, tcfg = jclip.tiny_clip_image_config(), jtext.tiny_clip_config()
    ip = random_flax_params(lambda k: jclip.CLIPImageEncoder(icfg).init(
        k, jnp.zeros((1, 32, 32, 3))), 0)
    tp = random_flax_params(lambda k: jtext.CLIPTextEncoder(tcfg).init(
        k, jnp.zeros((1, 77), jnp.int32)), 1)
    return {
        "jax": (jzoe.ZoeDepthEstimator(zcfg, params=zp),
                jlama.LamaInpainter(lcfg, params=lv),
                jseg.CLIPSegmenter(icfg, tcfg, ip, tp)),
        "port": (tzoe.ZoeDepthEstimator(tzoe.tiny_zoedepth_config(),
                                        params=zoedepth_state_dict(zp),
                                        device="cpu"),
                 tlama.LamaInpainter(tlama.tiny_lama_config(),
                                     params=lama_state_dict(
                                         lv, tlama.tiny_lama_config()),
                                     device="cpu"),
                 tseg.CLIPSegmenter(tclip.tiny_clip_image_config(),
                                    ttext.tiny_clip_config(),
                                    clip_vision_state_dict(ip),
                                    clip_state_dict(tp), device="cpu")),
    }


@pytest.fixture(scope="module")
def mesh_of_services(rig):
    """The four services the orchestrator calls, of each package, on the
    same weights; yields ({package: pipeline}, port core app, models)."""
    jh, th, _, _ = rig
    models = _models()
    (jz, jl, js), (tz, tl, ts) = models["jax"], models["port"]
    urls = {"jax": dict(
        diffhandles_url=_start_jax(jsvc.DiffhandlesWebapp, handles=jh),
        depth_url=_start_jax(jsvc.DepthEstimatorWebapp, estimator=jz),
        remover_url=_start_jax(jsvc.ForegroundRemoverWebapp, remover=jl),
        selector_url=_start_jax(jsvc.ForegroundSelectorWebapp,
                                selector=js), text2img_url=None)}
    apps = [tsvc.DiffhandlesWebapp(handles=th, port=0),
            tsvc.DepthEstimatorWebapp(estimator=tz, port=0),
            tsvc.ForegroundRemoverWebapp(remover=tl, port=0),
            tsvc.ForegroundSelectorWebapp(selector=ts, port=0)]
    urls["port"] = dict(zip(("diffhandles_url", "depth_url", "remover_url",
                             "selector_url"),
                            (_start_port(a) for a in apps)),
                        text2img_url=None)
    pipes = {"jax": japp.DiffhandlesPipeline(**urls["jax"]),
             "port": tapp.DiffhandlesPipeline(**urls["port"], device="cpu")}
    yield pipes, apps[0], models
    for app in apps:
        app.shutdown()


def _jax_edit(jh, st):
    """What the JAX core service's /transform_foreground computes, in the
    process: its handler's reply does not encode (the JAX facade returns
    the edited image as a jax.Array, which the codec passes through to
    json), so the JAX side of the comparison is taken here."""
    from diffusionhandles_tpu.checkpoint import load_identity as jload
    from diffusionhandles_tpu.checkpoint import to_nchw as jnchw
    ident = jload(io.BytesIO(st.input_image_identity))
    img, disparity = jh.transform_foreground(
        depth=st.depth, prompt=PROMPT, fg_mask=st.fg_mask,
        bg_depth=st.bg_depth, null_text_emb=ident["null_text_emb"],
        init_noise=jnchw(ident["init_noise"]),
        activations=[jnchw(a) for a in ident["activations"]],
        rot_angle=EDIT["rot_angle"],
        rot_axis=np.asarray(EDIT["rot_axis"], np.float32),
        translation=np.asarray(EDIT["translation"], np.float32))
    return np.asarray(img), np.asarray(disparity)


@pytest.fixture(scope="module")
def pipelines(rig, mesh_of_services):
    """Both orchestrators through the three steps on the rig's image: the
    fg mask through the selector first, then the rig's box mask."""
    jh, _, s, _ = rig
    pipes, _, _ = mesh_of_services
    out = {}
    for name, p in pipes.items():
        p.set_input_image(s["img"], PROMPT)
        p.set_foreground(fg_prompt=FG_PROMPT)
        selected = p.state.fg_mask.copy()
        p.set_foreground(fg_mask=s["fg_mask"])
        if name == "port":
            edited, disparity = p.transform_foreground(**EDIT)
        else:
            edited, disparity = _jax_edit(jh, p.state)
        out[name] = dict(state=copy.deepcopy(p.state), selected=selected,
                         edited=edited, disparity=disparity)
    return out


def test_pipeline_end_to_end_matches_jax(rig, mesh_of_services, pipelines):
    """Depth, the selector's mask, the background, its harmonized depth,
    the identity and the edit of the port's orchestrator over its
    services, against the JAX orchestrator over the JAX services."""
    _, _, s, _ = rig
    _, _, models = mesh_of_services
    t, j = pipelines["port"], pipelines["jax"]
    ts, js = t["state"], j["state"]
    np.testing.assert_allclose(ts.depth, js.depth, rtol=ZOE_RTOL,
                               atol=ZOE_ATOL)
    sim = models["port"][2].similarity_map(s["img"], FG_PROMPT)[0]
    lo, hi = np.percentile(sim, [5, 95])
    differ = t["selected"] != j["selected"]
    assert not (differ[0, 0] & (np.abs(sim - (lo + hi) / 2) > 1e-4)).any()
    np.testing.assert_allclose(ts.bg_img, js.bg_img, rtol=0, atol=LAMA_ATOL)
    np.testing.assert_allclose(ts.bg_depth, js.bg_depth, rtol=ZOE_RTOL,
                               atol=ZOE_ATOL)
    with_t, with_j = (_identity_arrays(x.input_image_identity)
                      for x in (ts, js))
    for k in with_j:
        close(with_t[k], with_j[k], f"identity {k}", IDENTITY_RTOL)
    assert t["edited"].shape == (1, 3, 32, 32)
    close(t["disparity"], j["disparity"], "edited disparity", EDIT_RTOL)
    close(t["edited"], j["edited"], "edited image", EDIT_RTOL)


def _identity_arrays(blob: bytes) -> dict:
    with np.load(io.BytesIO(blob)) as data:
        return {k: data[k] for k in data.files}


def test_previews_match_jax(mesh_of_services, pipelines):
    """preview_edit in 'depth' and 'rgb' mode on one state (the JAX
    pipeline's) in both packages."""
    pipes, _, _ = mesh_of_services
    state = pipelines["jax"]["state"]
    for p in pipes.values():
        p.state = copy.deepcopy(state)
    for mode in ("depth", "rgb"):
        got = pipes["port"].preview_edit(mode=mode, **EDIT)
        want = pipes["jax"].preview_edit(mode=mode, **EDIT)
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        assert got.shape == want.shape == (1, 1 if mode == "depth" else 3,
                                           32, 32)
        if mode == "depth":
            close(got, want, "depth preview", DISPARITY_RTOL)
            continue
        off = np.abs(got - want).max(1)[0] > RGB_ATOL
        assert off.mean() <= RGB_FLIPS, off.mean()
    with pytest.raises(ValueError, match="mode"):
        pipes["port"].preview_edit(mode="bogus")
    pipes["port"].state.bg_depth = None
    with pytest.raises(RuntimeError, match="set_foreground"):
        pipes["port"].preview_edit()


def test_core_requests_are_the_in_process_calls(rig, mesh_of_services,
                                                pipelines):
    """/set_input_image's identity loads to the tensors of the same
    inversion made in the process, and /transform_foreground over HTTP
    gives the bits of the in-process call on that identity."""
    _, th, s, _ = rig
    pipes, core, _ = mesh_of_services
    state = pipelines["port"]["state"]
    c = pipes["port"].diffhandles
    blob = c.set_input_image(s["img"], state.depth, PROMPT)
    assert core.last_request["route"] == "set_input_image"
    assert core.last_request["response_bytes"] > len(blob)
    null, noise = th.invert_input_image(s["img"], state.depth, PROMPT)
    null, noise, acts, latents = th.generate_input_image(
        state.depth, PROMPT, null, noise)
    got = _identity_arrays(blob)
    want = {"null_text_emb": null, "init_noise": noise,
            "latent_image": latents,
            **{f"activations{i + 1}": a for i, a in enumerate(acts)}}
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], np_(v).astype(np.float32),
                                      err_msg=k)

    out = c.transform_foreground(blob, state.depth, PROMPT, state.fg_mask,
                                 state.bg_depth, **EDIT)
    ident = load_identity(io.BytesIO(blob))
    img, disparity = th.transform_foreground(
        depth=state.depth, prompt=PROMPT, fg_mask=state.fg_mask,
        bg_depth=state.bg_depth, null_text_emb=ident["null_text_emb"],
        init_noise=to_nchw(ident["init_noise"]),
        activations=[to_nchw(a) for a in ident["activations"]],
        rot_angle=EDIT["rot_angle"],
        rot_axis=np.asarray(EDIT["rot_axis"], np.float32),
        translation=np.asarray(EDIT["translation"], np.float32))
    np.testing.assert_array_equal(out["edited_img"], img)
    np.testing.assert_array_equal(out["edited_disparity"], disparity)


def test_jax_identity_drives_the_port_service(rig, mesh_of_services,
                                              pipelines):
    """The identity the JAX core service made drives the port's core
    service, which then follows the JAX edit within the rig's
    tolerance."""
    pipes, _, _ = mesh_of_services
    j = pipelines["jax"]
    st = j["state"]
    out = pipes["port"].diffhandles.transform_foreground(
        st.input_image_identity, st.depth, PROMPT, st.fg_mask, st.bg_depth,
        **EDIT)
    close(out["edited_disparity"], j["disparity"], "edited disparity",
          DISPARITY_RTOL)
    close(out["edited_img"], j["edited"], "edited image", 5e-3)


def test_export_meshes_are_the_jax_writers_bytes(rig, mesh_of_services,
                                                 pipelines, tmp_path):
    """/set_foreground with export_meshes: the harmonized depth of the
    call without, and each GLB the JAX writer's bytes for the same
    mesh."""
    _, th, _, _ = rig
    pipes, _, _ = mesh_of_services
    st = pipelines["port"]["state"]
    raw_bg = pipes["port"].depth_estimator.estimate_depth(st.bg_img)
    out = pipes["port"].diffhandles.set_foreground(
        st.depth, st.fg_mask, raw_bg, export_meshes=True)
    np.testing.assert_array_equal(out["bg_depth_harmonized"], st.bg_depth)
    K = th.diffuser.get_depth_intrinsics()
    for name, d, mask in (("bg_depth_mesh", raw_bg, None),
                          ("fg_depth_mesh", st.depth, st.fg_mask[0, 0])):
        m = tmesh.depth_to_mesh(d, K, mask=mask, device="cpu")
        jm = jmesh.Mesh(verts=np_(m.verts),
                        faces=np_(m.faces).astype(np.int32),
                        vert_attributes={"color": np_(
                            m.vert_attributes["color"])})
        jio.save_mesh_glb(tmp_path / f"{name}.glb", jm)
        assert out[name] == (tmp_path / f"{name}.glb").read_bytes(), name


def test_pipeline_service_serves_the_orchestrator(mesh_of_services,
                                                  pipelines):
    """DiffhandlesPipelineWebapp over the port's orchestrator: the UI at
    GET /, and /preview_edit the bits of the orchestrator's call."""
    pipes, _, _ = mesh_of_services
    p = pipes["port"]
    p.state = copy.deepcopy(pipelines["port"]["state"])
    app = tapp.DiffhandlesPipelineWebapp(pipeline=p, port=0)
    url = _start_port(app)
    with urllib.request.urlopen(url + "/") as resp:
        assert b"DiffusionHandles" in resp.read()
    c = tclient.ServiceClient(url)
    for mode in ("depth", "rgb"):
        got = c.call("preview_edit", mode=mode, **EDIT)["preview"]
        np.testing.assert_array_equal(got, p.preview_edit(mode=mode,
                                                          **EDIT))
    app.shutdown()


def test_save_denoising_steps_raises_as_in_jax(rig, mesh_of_services,
                                               pipelines):
    """Under save_denoising_steps the facade returns three results; the
    core service unpacks two, as the JAX service does, and fails."""
    _, th, _, _ = rig
    pipes, _, _ = mesh_of_services
    st = pipelines["port"]["state"]
    with_guided(th, save_denoising_steps=True)
    try:
        with pytest.raises(RuntimeError, match="unpack"):
            pipes["port"].diffhandles.transform_foreground(
                st.input_image_identity, st.depth, PROMPT, st.fg_mask,
                st.bg_depth, **EDIT)
    finally:
        with_guided(th, save_denoising_steps=False)


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

def test_run_refuses_a_multi_host_launch(monkeypatch, capsys):
    """Under the env contract the launcher joins the process group on its
    GPU before it serves: with no GPU it raises (it never joins over gloo
    on its own); joined, it prints the JAX launcher's line and serves."""
    monkeypatch.setenv("DIFFHANDLES_COORDINATOR", "localhost:1")
    monkeypatch.setenv("DIFFHANDLES_NUM_PROCESSES", "2")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            trun.main(["depth", "--variant", "tiny"])
    from diffusionhandles_tpu_torch.parallel import distributed
    served = []
    monkeypatch.setattr(distributed, "maybe_init_from_env", lambda: dict(
        process_id=1, num_processes=2, local_devices=1, global_devices=2))
    monkeypatch.setattr(tbase.Webapp, "run", lambda self: served.append(
        self))
    monkeypatch.setattr(tapp, "resolve_device",
                        lambda device=None: torch.device("cpu"))
    trun.main(["pipeline"])
    assert isinstance(served[-1], tapp.DiffhandlesPipelineWebapp)
    assert ("joined distributed runtime: process 1/2, 1 local / 2 global "
            "devices") in capsys.readouterr().out


def test_run_pipeline_discovers_its_services(monkeypatch):
    """The pipeline service takes its upstream URLs from
    DIFFHANDLES_*_URL, and serves on the default port unless told."""
    monkeypatch.delenv("DIFFHANDLES_COORDINATOR", raising=False)
    served = []
    monkeypatch.setattr(tbase.Webapp, "run", lambda self: served.append(
        self))
    monkeypatch.setattr(tapp, "resolve_device",
                        lambda device=None: torch.device("cpu"))
    monkeypatch.setenv("DIFFHANDLES_CORE_URL", "http://core:1")
    monkeypatch.setenv("DIFFHANDLES_SELECTOR_URL", "http://sel:2")
    trun.main(["pipeline"])
    app = served[-1]
    assert isinstance(app, tapp.DiffhandlesPipelineWebapp)
    assert app.port == 8888 and app.index_html
    p = app.pipeline
    assert p.diffhandles.url == "http://core:1"
    assert p.selector.url == "http://sel:2"
    assert p.depth_estimator.url == "http://127.0.0.1:8890"
    trun.main(["pipeline", "--port", "9000", "--netpath", "/x/"])
    assert served[-1].port == 9000 and served[-1].netpath == "/x"
