"""Multi-device rendering: ``lens_flare_tpu_torch/parallel/``, ``Renderer(devices=)`` and ``--devices``/``-t``.

The counterparts of ``tests/test_sharding.py``, ``tests/test_multihost.py``
and ``tests/test_renderer.py``'s device cases, whose scenes are files of
the absent corpus; here terrain 8 and the Cornell box written in code.  The
JAX tests stand in 8 virtual CPU devices (``tests/conftest.py``); the port's
stand-in is a mesh that names one device several times
(``make_mesh(devices=[cpu] * 8)``), or ``parallel.mesh.available_devices``
monkeypatched to return it, which is what ``Renderer`` enumerates.

Tolerances: sharded against unsharded in the port is bit for bit (film,
counts, stats, PNG bytes, the ghost image); against the JAX package,
``tests/test_torch_integrator.py``'s rule for frames (>= 99% of pixels
within 1e-4 absolute plus 1e-4 relative, mean relative difference < 1e-3,
rays equal), and for the lens gradients rtol 1e-5 with atol 1e-5 of the
largest; the sharded train step against the unsharded one rtol 1e-6 (its
gradients are sums over other slabs of pixels, so the last bits differ).
"""

import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from lens_flare_tpu.lens.prescription import reference_prescription as j_reference_prescription
    from lens_flare_tpu.parallel import render as jrender
    from lens_flare_tpu.parallel.mesh import make_mesh as j_make_mesh
    from lens_flare_tpu.renderer import Renderer as JaxRenderer
    from lens_flare_tpu.scene.procedural import make_terrain_scene as j_make_terrain_scene
except ImportError:  # the card's machine: only the gpu cases can run
    jax = None

from lens_flare_tpu_torch import _rng, compiled, cli
from lens_flare_tpu_torch import renderer as rmod
from lens_flare_tpu_torch.convert import camera_params_from_numpy, prescription_from_numpy
from lens_flare_tpu_torch.diff.optimize import LENS_FIELDS, ghost_image
from lens_flare_tpu_torch.integrator.path import render_wavefront
from lens_flare_tpu_torch.lens.prescription import reference_prescription
from lens_flare_tpu_torch.ops import intersect_cuda as ic
from lens_flare_tpu_torch.parallel import mesh as pmesh
from lens_flare_tpu_torch.parallel import render as prender
from lens_flare_tpu_torch.renderer import Renderer
from lens_flare_tpu_torch.scene.camera import camera_params
from lens_flare_tpu_torch.scene.procedural import make_terrain_scene
from lens_flare_tpu_torch.scene.writer import cornell_box

from test_torch_compiled import cpu_capture  # noqa: F401  (the capture stand-in fixture)

ROOT = Path(__file__).resolve().parent.parent
CPU8 = [torch.device("cpu")] * 8
needs_jax = pytest.mark.skipif(jax is None, reason="needs the JAX package (the reference)")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: tier-1 runs six test processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def stand_ins(monkeypatch):
    """``Renderer`` and the command line find 8 devices: the CPU, eight times."""
    monkeypatch.setattr(pmesh, "available_devices", lambda device: list(CPU8))
    return CPU8


def _close(got, want, atol=1e-4, rtol=1e-4, frac=0.99):
    got = np.asarray(got, np.float64).reshape(-1, 3)
    want = np.asarray(want, np.float64).reshape(-1, 3)
    ok = (np.abs(got - want) <= atol + rtol * np.abs(want)).all(axis=1)
    assert ok.mean() >= frac, f"{ok.mean():.4f} of pixels within tolerance"
    rel = np.abs(got - want).sum() / max(np.abs(want).sum(), 1e-30)
    assert rel < 1e-3, rel


# ---------------------------------------------------------------------------
# mesh.py
# ---------------------------------------------------------------------------


def test_make_mesh_and_placement():
    assert pmesh.make_mesh(devices=CPU8) == tuple(CPU8)
    assert pmesh.make_mesh(3, devices=CPU8) == tuple(CPU8[:3])
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="at least one device"):
            pmesh.make_mesh()  # every CUDA device: none here
    x = torch.arange(24.0).reshape(8, 3)
    pieces = pmesh.shard_batch(x, CPU8[:4])
    assert [p.shape for p in pieces] == [(2, 3)] * 4 and torch.equal(torch.cat(pieces), x)
    with pytest.raises(ValueError, match="does not divide"):
        pmesh.shard_batch(x, CPU8[:3])
    r = Renderer(device="cpu", width=8, height=8)
    r.load_flat_scene(make_terrain_scene(8))
    replicas = pmesh.replicate(r.bundle, CPU8)
    assert list(replicas) == [torch.device("cpu")]  # once per distinct device, not per shard
    assert replicas[torch.device("cpu")].cscene.tri is r.bundle.cscene.tri  # already there: not copied
    with pytest.raises(ValueError, match="no replica"):
        prender.replica({}, torch.device("cpu"))
    pmesh.init_distributed()  # one process: nothing to join
    pmesh.init_distributed("127.0.0.1:1", 1, 0)  # nor with a count of one: no port is bound, no group formed
    assert pmesh.group() == (0, 1) and not pmesh.distributed()


# ---------------------------------------------------------------------------
# render_sharded
# ---------------------------------------------------------------------------

W = H = 16
KW = dict(width=W, height=H, ns_aa=2, max_ray_depth=3, ns_area_light=1, indirect=True, seed=0)


@pytest.fixture(scope="module")
def terrain():
    r = Renderer(device="cpu", **KW)
    r.load_flat_scene(make_terrain_scene(8))
    i = torch.arange(W * H)
    return r, i % W, i // W


def test_render_sharded_bit_equal(terrain):
    r, px, py = terrain
    cam, key = camera_params(r.camera, "cpu"), _rng.prng_key(3)
    want = render_wavefront(r.bundle, r.settings, cam, px, py, W, H, key)
    got = prender.render_sharded(r.bundle, r.settings, cam, px, py, W, H, key, mesh=pmesh.make_mesh(devices=CPU8))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[2][0] > 0


@needs_jax
def test_render_sharded_matches_jax(terrain):
    """Against JAX's ``render_sharded`` on its 8-device virtual CPU mesh (its XLA binary-BVH trace)."""
    r, px, py = terrain
    jr = JaxRenderer(use_pallas=False, **KW)
    jr.load_flat_scene(j_make_terrain_scene(8))
    assert len(jax.devices()) == 8
    want = jrender.render_sharded(
        jr.bundle, jr.settings, jr.camera.params(), jnp.asarray(px.numpy()), jnp.asarray(py.numpy()), W, H,
        jax.random.PRNGKey(3), mesh=j_make_mesh(),
    )
    got = prender.render_sharded(
        r.bundle, r.settings, camera_params_from_numpy(jr.camera.params()), px, py, W, H, _rng.prng_key(3),
        mesh=pmesh.make_mesh(devices=CPU8),
    )
    _close(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy()[[0, 2]], np.asarray(want[2])[[0, 2]])


# ---------------------------------------------------------------------------
# Renderer(devices=) and the command line
# ---------------------------------------------------------------------------

FRAMES = {
    # odd width: padded lanes and a ragged last tile (test_renderer.py:198-227)
    "tiled": dict(ns_aa=2, max_ray_depth=2, indirect=True, tile_pixels=256, width=33, height=20),
    "adaptive": dict(ns_aa=8, samples_per_batch=2, max_ray_depth=2, indirect=True, tile_pixels=256, width=33,
                     height=20),
}


@pytest.mark.parametrize("mode", list(FRAMES))
def test_renderer_devices_writes_the_same_png(mode, stand_ins, tmp_path):
    pngs, stats = {}, {}
    for devices in (1, 0):
        r = Renderer(device="cpu", devices=devices, **FRAMES[mode])
        r.load_flat_scene(make_terrain_scene(8))
        assert r.n_shards == (8 if devices == 0 else 1)
        path = tmp_path / f"d{devices}.png"
        r.render_to_file(str(path))
        pngs[devices] = path.read_bytes()
        stats[devices] = (r.stats.total_rays, r.stats.total_isects, r.stats.total_zero_skipped)
    assert r.tile_pixels == 256 and len(r._replicas) == 1
    assert pngs[1] == pngs[0] and stats[1] == stats[0]


@pytest.mark.parametrize("mode", list(FRAMES))
def test_sharded_render_under_capture(mode, stand_ins, cpu_capture):  # noqa: F811
    """Every shard replays the programs of its device (one set for the 8 stand-ins), equal to eager."""
    r = Renderer(device="cpu", devices=0, **FRAMES[mode])
    r.load_flat_scene(make_terrain_scene(8))
    with compiled.disabled():
        want = r.render(progress=False)
        want_stats = (r.stats.total_rays, r.stats.total_isects)
    got = r.render(progress=False)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (r.stats.total_rays, r.stats.total_isects) == want_stats
    assert len(r._programs) >= 2
    lanes = {inputs[0][0][0] for (key, inputs) in r._programs._programs}
    assert max(lanes) == 256 // 8, lanes  # programs hold one shard's lanes


def test_checkpoint_resumes_on_another_device_count(stand_ins, tmp_path, monkeypatch):
    """A tiled and an adaptive render interrupted on one device resume on 8 stand-ins, bit-equal."""

    class Interrupted(Exception):
        pass

    for mode, call, after in (("tiled", "render_wavefront", 2), ("adaptive", "render_batch", 3)):
        kw = FRAMES[mode]
        full = Renderer(device="cpu", **kw)
        full.load_flat_scene(make_terrain_scene(8))
        want = full.render(progress=False)
        path = tmp_path / f"{mode}.npz"
        fn, calls = getattr(rmod, call), []

        def wrapped(*args, **k):
            calls.append(1)
            if len(calls) > after:
                raise Interrupted
            return fn(*args, **k)

        with monkeypatch.context() as m:
            m.setattr(rmod, call, wrapped)
            r1 = Renderer(device="cpu", **kw)
            r1.load_flat_scene(make_terrain_scene(8))
            with pytest.raises(Interrupted):
                r1.render(progress=False, checkpoint_path=path)
        r8 = Renderer(device="cpu", devices=0, **kw)
        r8.load_flat_scene(make_terrain_scene(8))
        got = r8.render(progress=True, checkpoint_path=path)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), mode
        assert r8.stats.total_rays == full.stats.total_rays


@pytest.fixture(scope="module")
def cornell_file(tmp_path_factory):
    return cornell_box().write(tmp_path_factory.mktemp("cornell") / "cornell.dae")


def test_cli_devices_flags(cornell_file, stand_ins, tmp_path, capsys):
    """``--devices 8``, ``-t 8`` and the default (0: all) write the PNG of ``--devices 1`` (test_renderer.py:229-255)."""
    outs = {}
    for name, flags in (("one", ["--devices", "1"]), ("eight", ["--devices", "8"]), ("t8", ["-t", "8"]),
                        ("all", [])):
        out = tmp_path / f"{name}.png"
        assert cli.main(["-s", "2", "-m", "2", "-r", "24", "24", *flags, "-f", str(out), "--device", "cpu",
                         str(cornell_file)]) == 0
        printed = capsys.readouterr().out
        assert f"Rendering on {1 if name == 'one' else 8} shard(s) over 1 device(s)" in printed, printed
        outs[name] = out.read_bytes()
    assert outs["one"] == outs["eight"] == outs["t8"] == outs["all"]


# ---------------------------------------------------------------------------
# the row-sharded ghost image and the train step
# ---------------------------------------------------------------------------

GW, GH = 48, 40  # H divides over 8 shards


def _ghost_inputs():
    tex = torch.as_tensor(np.random.default_rng(0).uniform(0, 1, (12, 12)), dtype=torch.float32)
    return tex, torch.tensor([0.6, 0.55]), 0.4


def test_row_sharded_ghost_image(monkeypatch):
    tex, axis, angle = _ghost_inputs()
    lens = reference_prescription()
    want = ghost_image(lens, tex, axis, angle, GW, GH)
    calls = []
    splat = prender.splat_eval

    def counting(tex, r1s, r2s, colors, axis_ray, width, height, xs, ys, smooth=False):
        calls.append((xs.shape[0], int(ys.min()), int(ys.max())))
        return splat(tex, r1s, r2s, colors, axis_ray, width, height, xs, ys, smooth)

    monkeypatch.setattr(prender, "splat_eval", counting)
    got = prender.ghost_image_from_lens(lens, tex, axis, angle, GW, GH, mesh=pmesh.make_mesh(devices=CPU8))
    assert torch.equal(got, want) and want.sum() > 0
    # each shard evaluated its own H/8 rows only (the FLOPs check of test_sharding.py:130-138)
    rows = GH // 8
    assert calls == [(GW * rows, i * rows, (i + 1) * rows - 1) for i in range(8)]
    with pytest.raises(ValueError, match="must divide over 8"):
        prender.ghost_image_from_lens(lens, tex, axis, angle, GW, GH + 1, mesh=pmesh.make_mesh(devices=CPU8))


@needs_jax
def test_sharded_lens_gradients_match_jax():
    """``test_sharding.py:66-91``: gradients of the row-sharded image against JAX's sharded ones."""
    w = h = 24
    jlens = j_reference_prescription()
    jtex, jaxis, jangle = jnp.ones((8, 8)) * 0.5, jnp.asarray([0.6, 0.55]), jnp.float32(0.4)

    def jloss(lens):
        img = jrender.ghost_image_from_lens(lens, jtex, jaxis, jangle, w, h, mesh=j_make_mesh())
        return jnp.mean(img**2)

    jg = jax.jit(jax.grad(jloss))(jlens)
    lens = prescription_from_numpy(jlens)
    for f in LENS_FIELDS:
        getattr(lens, f).requires_grad_(True)
    img = prender.ghost_image_from_lens(lens, torch.full((8, 8), 0.5), torch.tensor([0.6, 0.55]), 0.4, w, h,
                                        mesh=pmesh.make_mesh(devices=CPU8))
    torch.mean(img**2).backward()
    for f in LENS_FIELDS:
        want = np.asarray(getattr(jg, f))
        np.testing.assert_allclose(getattr(lens, f).grad.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_sharded_train_step_equals_unsharded():
    tex, axis, angle = _ghost_inputs()
    target = torch.zeros((GH, GW, 3))
    lens_u, step_u = prender.make_train_step(reference_prescription(), tex, axis, angle, GW, GH)
    lens_s, step_s = prender.make_train_step(reference_prescription(), tex, axis, angle, GW, GH,
                                             mesh=pmesh.make_mesh(devices=CPU8))
    for _ in range(2):
        loss_u, loss_s = step_u(target), step_s(target)
        np.testing.assert_allclose(loss_s.item(), loss_u.item(), rtol=1e-6)
        for f in LENS_FIELDS:
            np.testing.assert_allclose(getattr(lens_s, f).detach().numpy(), getattr(lens_u, f).detach().numpy(),
                                       rtol=1e-6, atol=1e-9)
    assert not torch.equal(lens_u.curvatures, reference_prescription().curvatures)  # the step moved the lens


# ---------------------------------------------------------------------------
# two processes (gloo), the counterpart of test_multihost.py
# ---------------------------------------------------------------------------

WORKER = textwrap.dedent(
    """
    import sys
    import torch

    torch.set_num_threads(1)
    pid, port, out_dir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    from lens_flare_tpu_torch import _rng
    from lens_flare_tpu_torch.diff.optimize import LENS_FIELDS, ghost_image
    from lens_flare_tpu_torch.integrator.path import render_wavefront
    from lens_flare_tpu_torch.lens.prescription import reference_prescription
    from lens_flare_tpu_torch.parallel import mesh as pmesh, render as prender
    from lens_flare_tpu_torch.renderer import Renderer
    from lens_flare_tpu_torch.scene.camera import camera_params
    from lens_flare_tpu_torch.scene.procedural import make_terrain_scene

    pmesh.init_distributed(f"127.0.0.1:{port}", num_processes=2, process_id=pid)
    assert pmesh.group() == (pid, 2) and "gloo" in torch.distributed.get_backend()
    mesh = pmesh.make_mesh(devices=["cpu", "cpu"])  # 2 stand-in devices per process, 4 shards in all

    # depth 2 at 1 spp, as the JAX worker: the bounce loop's stats are all-reduced too
    r = Renderer(device="cpu", width=16, height=16, ns_aa=1, max_ray_depth=2, indirect=True)
    r.load_flat_scene(make_terrain_scene(8))
    i = torch.arange(256)
    px, py = i % 16, i // 16
    cam, key = camera_params(r.camera, "cpu"), _rng.prng_key(7)
    want = render_wavefront(r.bundle, r.settings, cam, px, py, 16, 16, key)
    got = prender.render_sharded(r.bundle, r.settings, cam, px, py, 16, 16, key, mesh=mesh)
    for g, w in zip(got, want):
        assert torch.equal(g, w), (g, w)
    assert got[2][0] > 0

    tex, axis = torch.ones((8, 8)), torch.tensor([0.3, 0.2])
    target = ghost_image(reference_prescription(), tex, axis, 0.25, 16, 16) * 1.1
    img = prender.ghost_image_from_lens(reference_prescription(), tex, axis, 0.25, 16, 16, mesh=mesh)
    assert torch.equal(img, ghost_image(reference_prescription(), tex, axis, 0.25, 16, 16))
    lens_s, step_s = prender.make_train_step(reference_prescription(), tex, axis, 0.25, 16, 16, mesh=mesh)
    lens_u, step_u = prender.make_train_step(reference_prescription(), tex, axis, 0.25, 16, 16)
    loss_s, loss_u = step_s(target), step_u(target)
    assert torch.isfinite(loss_s) and abs(loss_s.item() - loss_u.item()) <= 1e-6 * abs(loss_u.item())
    for f in LENS_FIELDS:
        a, b = getattr(lens_s, f).detach(), getattr(lens_u, f).detach()
        assert torch.allclose(a, b, rtol=1e-6, atol=1e-9), (f, a, b)

    # the Renderer under the group: each rank renders its block of every tile or chunk over its two
    # stand-ins (4 shards in all), and every rank gets the whole film of one process
    pmesh.available_devices = lambda device: [torch.device("cpu")] * 2
    for kw in (dict(ns_aa=2), dict(ns_aa=8, samples_per_batch=2)):  # tiled (a ragged last tile), adaptive
        frames = {}
        for devices in (1, 0):
            rd = Renderer(device="cpu", width=15, height=12, max_ray_depth=2, indirect=True, tile_pixels=64,
                          devices=devices, **kw)
            rd.load_flat_scene(make_terrain_scene(8))
            assert rd.n_shards == (4 if devices == 0 else 1)
            frames[devices] = (*rd.render(progress=False), rd.stats.total_rays, rd.stats.total_isects)
        assert all(torch.equal(a, b) for a, b in zip(frames[0][:2], frames[1][:2])), kw
        assert frames[0][2:] == frames[1][2:], (kw, frames[0][2:], frames[1][2:])
    torch.distributed.destroy_process_group()
    open(f"{out_dir}/ok_{pid}", "w").write("ok")
    print(f"[torch multihost worker {pid}] OK")
    """
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_workers(tmp_path):
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    procs = [
        subprocess.Popen([sys.executable, "-c", WORKER, str(pid), str(port), str(tmp_path)], cwd=ROOT, env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])  # each process: 120 s at most
    except subprocess.TimeoutExpired:
        outs.append("timed out")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ok = all(p.returncode == 0 for p in procs) and all((tmp_path / f"ok_{pid}").exists() for pid in range(2))
    return ok, procs, outs


@pytest.mark.multihost
def test_two_process_sharded_render(tmp_path):
    """2 processes x 2 stand-in CPU devices over gloo: ``render_sharded`` and ``Renderer(devices=0)``
    (tiled and adaptive) bit-equal to one process, the train step's loss finite and its update that of
    the unsharded step (rtol 1e-6).  One retry with a fresh
    port: the free-port grab is racy, as in test_multihost.py."""
    ok, procs, outs = _run_workers(tmp_path)
    if not ok:
        ok, procs, outs = _run_workers(tmp_path)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert (tmp_path / f"ok_{pid}").exists()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("mode", list(FRAMES))
def test_two_shards_on_card(mode, monkeypatch):
    """2 stand-in shards on cuda:0 (and every card, where there are more), replayed and eager, bit-equal to one device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    want_r = Renderer(device="cuda", **FRAMES[mode])
    want_r.load_flat_scene(make_terrain_scene(40))
    ic.reset_launch_counts()
    want = want_r.render(progress=False)
    meshes = [[torch.device("cuda", 0)] * 2]
    if torch.cuda.device_count() > 1:
        meshes.append([torch.device("cuda", i) for i in range(torch.cuda.device_count())])
    for devices in meshes:
        monkeypatch.setattr(pmesh, "available_devices", lambda device, devices=devices: list(devices))
        r = Renderer(device="cuda", devices=0, **FRAMES[mode])
        r.load_flat_scene(make_terrain_scene(40))
        assert r.n_shards == len(devices)
        with compiled.disabled():
            eager = r.render(progress=False)
        for got in (eager, r.render(progress=False), r.render(progress=False)):
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            assert r.stats.total_rays == want_r.stats.total_rays
