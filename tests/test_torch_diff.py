"""Differentiable rendering in the port against the JAX package's ``diff.render``.

The scene is the Cornell box of ``chip_smoke.py``'s COLLADA writer (the
.dae corpus is not in the repository), loaded by each package's own
loader, with the camera aimed at the ceiling emitter as in
``tests/test_diff_render.py`` so that the emitter's BSDF row is seen
directly; 16x12 pixels, 2 jittered samples, depth 2.  The inputs and the
rows the gradients are taken in come from ``chip_smoke.py``'s
``diff_case`` and ``emitter_params``, which its ``diff_small`` phase
drives on the card.  In
this box the emitting ceiling panel (the emitter's BSDF row) and the area
light (the light row) are two emitters; ``set_emitter_color`` drives both
with one colour, as the JAX demo does with the rows it picks.  The JAX
side traces through its XLA binary-BVH walk, the port through the plain
versions of kernels A and C.  Both draw the same threefry tape (the
pixel jitter included), so the estimators are the same lane for lane.

Tolerances and why: the render to rtol 1e-5 (atol 1e-6) and the gradients
with respect to the emitter's BSDF radiance row, the area light's
light-table row and a wall's albedo to rtol 1e-4 of ``jax.grad``'s (both
round in float32; XLA:CPU fuses multiply-adds, ROADMAP Queue 3 item 4).
The central differences use ``tests/test_diff_render.py``'s eps and rtol:
the estimator is linear in the emitter rows, quadratic in the albedo at
depth 2.  ``recover_emitter`` (init (2, 2, 2), lr 0.2, 80 steps) gives
JAX's losses to rtol 1e-3 at every step: Adam's update is computed in
another order, which drifts by ulps per step.  On the card
(``-m gpu``), the render and its gradients equal the CPU's to rtol 1e-4:
the kernels give the plain versions' hits bit for bit, the shading math
rounds in another order, and the gathers' backward adds with atomics.

The environment map's texel gradient (``tests/test_diff_render.py:184``)
is taken on an open terrain under an 8x16 sky: the image to rtol 1e-5
(atol 1e-6), the gradient in every texel to rtol 1e-4 of ``jax.grad``'s
(1.0e-5 read), with the same set of texels reached, and to rtol 1e-4 of a
central difference (eps 0.05, as the JAX test) at the largest texel
(4.5e-6 read): the image is linear in the texels, so only the float32
loss's rounding is left.
"""

import copy
from types import SimpleNamespace

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from lens_flare_tpu.accel import build_bvh as j_build_bvh
    from lens_flare_tpu.diff import render as jdr
    from lens_flare_tpu.integrator import path as jpath
    from lens_flare_tpu.integrator.envlight import build_env as j_build_env
    from lens_flare_tpu.integrator.lights import LT_ENV as J_LT_ENV
    from lens_flare_tpu.integrator.lights import lights_to_device as j_lights_to_device
    from lens_flare_tpu.integrator.shading import bsdf_to_device as j_bsdf_to_device
    from lens_flare_tpu.ops import scene_to_device as j_scene_to_device
    from lens_flare_tpu.scene.build import load_scene as j_load_scene
    from lens_flare_tpu.scene.camera import CameraParams as JCameraParams
except ImportError:  # the card's machine: only the gpu case can run
    jax = None

import chip_smoke
from lens_flare_tpu_torch.diff import render as tdr
from lens_flare_tpu_torch.integrator import path as tpath
from lens_flare_tpu_torch.scene.build import LT_AREA

W, H = 16, 12
SPP = 2
DEPTH = 2
TRUE_COLOR = (0.9, 0.55, 0.2)
# (eps, rtol) per parameter, as tests/test_diff_render.py checks them
FD = {"emitter": (0.1, 2e-2), "light": (0.1, 2e-2), "albedo": (0.02, 5e-2)}
FD_TEXEL_RTOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: tier-1 runs six test processes on the machine's cores, and the
    small tensors here lose most of their time to oversubscribed thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_case(path, device, **renderer_kw):
    """The port's ``render_image`` inputs for the Cornell box on ``device``, camera on the emitter."""
    return chip_smoke.diff_case(path, device, W, H, SPP, DEPTH, aim=True, **renderer_kw)


def render(c, bundle):
    return chip_smoke.diff_render(c, bundle)


def objective(c, bundle):
    return torch.sum(c.window * render(c, bundle))


def port_grads(c):
    """d(objective)/d(row) for every row of ``emitter_params``, one backward pass."""
    return chip_smoke.diff_grads(c, chip_smoke.emitter_params(c.r.scene))[1]


@pytest.fixture(scope="module")
def cornell(tmp_path_factory):
    return chip_smoke.cornell_box().write(tmp_path_factory.mktemp("diff") / "cornell.dae")


@pytest.fixture(scope="module")
def case(cornell):
    return port_case(cornell, "cpu")


@pytest.fixture(scope="module")
def params(case):
    return chip_smoke.emitter_params(case.r.scene)


def _with_env_row(lt):
    """A copy of the JAX light table with the LT_ENV row the JAX ``Renderer`` appends (``renderer.py:145-160``)."""
    lt = copy.deepcopy(lt)
    lt.light_type = np.append(lt.light_type, J_LT_ENV).astype(np.int32)
    for name in ("radiance", "position", "direction", "dim_x", "dim_y"):
        setattr(lt, name, np.vstack([getattr(lt, name), np.zeros(3, np.float32)]))
    lt.area = np.append(lt.area, 0.0).astype(np.float32)
    lt.is_delta = np.append(lt.is_delta, False)
    return lt


def _jax_bundle(path, envmap=None):
    scene, _ = j_load_scene(path)
    lt = scene.lights if envmap is None else _with_env_row(scene.lights)
    bundle = jpath.SceneBundle(
        scene=j_scene_to_device(scene, j_build_bvh(*scene.primitive_bboxes())),
        bsdfs=j_bsdf_to_device(scene.bsdfs), lights=j_lights_to_device(lt),
        env=None if envmap is None else j_build_env(envmap), pscene=None,
    )
    return scene, lt, bundle


def _jax_case(path, c, envmap=None):
    """The JAX package's bundle, settings and camera for the file of the port's case ``c``: its pixels,
    key, sample count, depth and window; ``envmap``: under that environment map."""
    scene, lt, bundle = _jax_bundle(path, envmap)
    settings = jpath.make_settings(
        lt, ns_aa=c.n, max_ray_depth=c.settings.max_ray_depth, ns_area_light=1,
        indirect=c.settings.indirect, samples_per_batch=c.n, max_tolerance=0.0, bsdf_table=scene.bsdfs,
    )
    cam = JCameraParams(*(jnp.asarray(v) for v in c.r.camera.params()))
    return SimpleNamespace(
        bundle=bundle, settings=settings, cam=cam, px=jnp.asarray(c.px.numpy()), py=jnp.asarray(c.py.numpy()),
        key=jax.random.PRNGKey(3), window=jnp.asarray(c.window.numpy()), width=c.width, height=c.height, n=c.n,
    )


@pytest.fixture(scope="module")
def jax_case(case, cornell):
    return _jax_case(cornell, case)


def _jax_render(j, bundle):
    return jdr.render_image(bundle, j.settings, j.cam, j.px, j.py, j.width, j.height, j.key, j.n)


def _jax_image_and_grads(j, params):
    """JAX's image and the gradients of sum(window * image) in every row of ``params`` (one compile)."""

    def image_and_grads(values):
        def image(values):
            b = j.bundle
            for name, (group, field, row) in params.items():
                g = getattr(b, group)
                value = values[name] if row is None else getattr(g, field).at[row].set(values[name])
                b = b._replace(**{group: g._replace(**{field: value})})
            return _jax_render(j, b)

        img, vjp = jax.vjp(image, values)
        return img, vjp(j.window)[0]

    def table(group, field, row):
        t = getattr(getattr(j.bundle, group), field)
        return t if row is None else t[row]

    start = {name: table(*where) for name, where in params.items()}
    img, grads = jax.jit(image_and_grads)(start)
    return np.asarray(img), {name: np.asarray(g) for name, g in grads.items()}


@pytest.fixture(scope="module")
def jax_ref(jax_case, params):
    return _jax_image_and_grads(jax_case, params)


def test_render_image_matches_jax(case, jax_ref):
    want = jax_ref[0]
    got = render(case, case.bundle).numpy()
    assert want.max() > 1.0  # the emitter is in view
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def grads(case):
    return port_grads(case)


@pytest.mark.parametrize("name", list(FD))
def test_gradient_matches_jax_grad(name, grads, jax_ref):
    want = jax_ref[1][name]
    assert np.linalg.norm(want) > 1e-4
    np.testing.assert_allclose(grads[name].numpy(), want, rtol=1e-4)


@pytest.mark.parametrize("name", list(FD))
def test_gradient_matches_central_differences(name, case, params, grads):
    (group, field, row), (eps, rtol) = params[name], FD[name]
    row0 = getattr(getattr(case.bundle, group), field)[row]
    fd = np.zeros(3)
    with torch.no_grad():
        for ch in range(3):
            e = torch.zeros(3)
            e[ch] = eps
            hi = float(objective(case, tdr.replace_row(case.bundle, group, field, row, row0 + e)))
            lo = float(objective(case, tdr.replace_row(case.bundle, group, field, row, row0 - e)))
            fd[ch] = (hi - lo) / (2 * eps)
    g = grads[name].numpy()
    np.testing.assert_allclose(g, fd, rtol=rtol, atol=1e-4)
    assert np.linalg.norm(g) > 1e-4, "gradient is identically zero"


def test_set_emitter_color_writes_nothing(case, params):
    er, lr = params["emitter"][2], params["light"][2]
    before = (case.bundle.bsdfs.radiance.clone(), case.bundle.lights.radiance.clone())
    b = tdr.set_emitter_color(case.bundle, er, lr, TRUE_COLOR)
    assert torch.equal(case.bundle.bsdfs.radiance, before[0]) and torch.equal(case.bundle.lights.radiance, before[1])
    assert b.bsdfs.radiance[er].tolist() == pytest.approx(TRUE_COLOR)
    assert b.lights.radiance[lr].tolist() == pytest.approx(TRUE_COLOR)


def test_recover_emitter_matches_jax(case, jax_case, params):
    """tests/test_diff_render.py's demo: init (2, 2, 2), lr 0.2, 80 steps, the same key at every step."""
    c, j = case, jax_case
    er, lr = params["emitter"][2], params["light"][2]
    target = render(c, tdr.set_emitter_color(c.bundle, er, lr, TRUE_COLOR))
    j_target = jax.jit(lambda b: _jax_render(j, b))(jdr.set_emitter_color(j.bundle, er, lr, jnp.asarray(TRUE_COLOR)))
    np.testing.assert_allclose(target.numpy(), np.asarray(j_target), rtol=1e-5, atol=1e-6)
    kw = dict(init_color=(2.0, 2.0, 2.0), n_samples=SPP, steps=80, learning_rate=0.2)
    color, losses = tdr.recover_emitter(
        c.bundle, c.settings, c.cam, c.px, c.py, W, H, target, er, lr, key=c.key, **kw)
    _, j_losses = jdr.recover_emitter(
        j.bundle, j.settings, j.cam, j.px, j.py, W, H, j_target, er, lr, key=j.key, **kw)
    np.testing.assert_allclose(losses, j_losses, rtol=1e-3)
    assert losses[-1] < losses[0] * 1e-3, losses[::20]
    np.testing.assert_allclose(color.numpy(), TRUE_COLOR, atol=0.05)


def test_gradients_where_bounces_miss_match_jax(tmp_path):
    """An open terrain file, depth 3: missed bounce vertices lie ~3e38 away (the kernels' miss distance)
    and their masked NEE factors must not turn the zero cotangents into NaN."""
    path = chip_smoke.terrain_dae(6).write(tmp_path / "terrain.dae")
    c = chip_smoke.diff_case(path, "cpu", W, H, 1, 3)
    area = int(np.flatnonzero(c.r.scene.lights.light_type == LT_AREA)[0])
    params = {"light": ("lights", "radiance", area), "albedo": ("bsdfs", "albedo", 0)}
    got = chip_smoke.diff_grads(c, params)[1]
    want = _jax_image_and_grads(_jax_case(path, c), params)[1]
    for name, g in got.items():
        assert torch.isfinite(g).all() and g.abs().sum() > 0, (name, g)
        np.testing.assert_allclose(g.numpy(), want[name], rtol=1e-4)


def test_envmap_texel_gradient_matches_jax(tmp_path):
    """``tests/test_diff_render.py:184`` on an open terrain written in code, the camera pulled back so
    that rays miss: the gradient of sum(window * image) in every texel of an 8x16 map, through the miss
    lookup and the environment light's NEE slot, against ``jax.grad`` and a central difference at the
    largest texel.  The CDF tables stay the original map's on both sides."""
    path = chip_smoke.terrain_dae(6).write(tmp_path / "terrain.dae")
    sky = np.random.default_rng(5).uniform(0.2, 1.5, (8, 16, 3)).astype(np.float32)
    c = chip_smoke.diff_case(path, "cpu", W, H, SPP, DEPTH, back=1.5, envmap=sky)
    params = {"texels": ("env", "data", None)}
    image, got, _, _ = chip_smoke.diff_grads(c, params)
    g = got["texels"].numpy()
    want_image, want = _jax_image_and_grads(_jax_case(path, c, envmap=sky), params)
    np.testing.assert_allclose(image.numpy(), want_image, rtol=1e-5, atol=1e-6)
    # the texels the misses and the NEE samples read: the same set on both sides
    assert np.count_nonzero(g) >= 30 and np.array_equal(g != 0, want["texels"] != 0)
    np.testing.assert_allclose(g, want["texels"], rtol=1e-4)
    # central difference at the largest texel: the image is linear in the texels
    yy, xx, cc = np.unravel_index(np.argmax(np.abs(g)), g.shape)
    eps = 0.05
    with torch.no_grad():
        fd = []
        for sign in (1, -1):
            data = c.bundle.env.data.clone()
            data[yy, xx, cc] += sign * eps
            fd.append(float(objective(c, tdr.set_env_texels(c.bundle, data))))
    np.testing.assert_allclose(g[yy, xx, cc], (fd[0] - fd[1]) / (2 * eps), rtol=FD_TEXEL_RTOL)


def _tensors(x):
    if torch.is_tensor(x):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _tensors(v)]
    if hasattr(x, "__dataclass_fields__"):
        return [t for f in x.__dataclass_fields__ for t in _tensors(getattr(x, f))]
    return []


@pytest.mark.parametrize("tree", ["cluster_tree", "binary_bvh"])
def test_trace_gets_no_gradient(tree, cornell, monkeypatch):
    """No tensor that reaches the trace (A-D, G or their plain versions) or finalize_hit requires a gradient."""
    c = port_case(cornell, "cpu", use_wide_tree=tree == "cluster_tree")
    assert (c.bundle.cscene is None) == (tree == "binary_bvh")
    calls = []

    def spy(name, fn):
        def wrapped(*args, **kw):
            calls.append((name, [t.requires_grad for t in _tensors([args, list(kw.values())])]))
            return fn(*args, **kw)

        monkeypatch.setattr(tpath, name, wrapped)

    for name in ("walk_slots", "bvh_walk", "finalize_hit"):
        spy(name, getattr(tpath, name))
    grads = port_grads(c)
    traced = {name for name, _ in calls}
    assert traced == ({"walk_slots", "finalize_hit"} if tree == "cluster_tree" else {"bvh_walk", "finalize_hit"})
    assert not any(any(flags) for _, flags in calls)
    assert all(torch.isfinite(g).all() and g.abs().sum() > 0 for g in grads.values())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_gradients_on_card_match_cpu(cornell, cuda_device):
    """The render and its gradients through kernels A and C equal the plain versions' on the CPU."""
    from lens_flare_tpu_torch.ops import intersect_cuda as ic

    gpu, cpu = port_case(cornell, "cuda"), port_case(cornell, "cpu")
    ic.reset_launch_counts()
    img, g_gpu = render(gpu, gpu.bundle), port_grads(gpu)
    torch.cuda.synchronize()
    assert ic.KERNELS["A"].launches > 0 and ic.KERNELS["C"].launches > 0
    np.testing.assert_allclose(img.cpu().numpy(), render(cpu, cpu.bundle).numpy(), rtol=1e-4, atol=1e-5)
    for name, g in port_grads(cpu).items():
        np.testing.assert_allclose(g_gpu[name].cpu().numpy(), g.numpy(), rtol=1e-4, atol=1e-4 * float(g.abs().max()))
