"""Every BSDF family and light type of the port against the JAX package's, on the same inputs.

Material and light tables are built in code (every family, every light
type but the environment light, which ``tests/test_torch_envlight.py``
holds to the JAX package), directions and uniforms come from numpy seeds, and the JAX functions (``eval_f``,
``sample_f``, ``sample_light``, ``sample_light_static``) and the port's
run on the same arrays.  Tolerance: rtol 1e-5, atol 1e-6 on every float
output (XLA:CPU and ATen differ in the last ulps of exp, tan, acos and
fused products), exact on the boolean ``valid``.  A sample's f, wi and pdf
are compared where it is valid, the only lanes the integrator reads them
on: an invalid microfacet sample can have wo . h near 0, where the pdf is
a quotient by a cancelled dot product (one lane in 4,096 of the seed
below differs by 2.3e-5 relative there; valid lanes agree to 1.4e-6).
The sphere light's pdf, 1 / (2 pi (1 - cos_max)), is held at that
tolerance on all but 0.1% of lanes and at 1e-4 on every lane: 1 - cos_max
cancels, and amplifies a 1-ulp difference in |c - p| (XLA fuses the norm's
multiply-adds: an FMA evaluation reproduces its distance on every lane;
2 lanes of 4,096 below differ by 1.1e-5).  The uniforms include the mesh
light's CDF values themselves and a zero-area triangle's repeated CDF
entry, where the triangle pick must take jnp's first index.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lens_flare_tpu.integrator import lights as j_lights
from lens_flare_tpu.integrator import shading as j_shading
from lens_flare_tpu.scene import build as j_build
from lens_flare_tpu.scene.collada import MaterialInfo as JaxMaterial
from lens_flare_tpu_torch.integrator import lights, shading
from lens_flare_tpu_torch.integrator.path import make_settings
from lens_flare_tpu_torch.scene import build
from lens_flare_tpu_torch.scene.collada import (
    BSDF_DIFFUSE,
    BSDF_EMISSION,
    BSDF_GLASS,
    BSDF_MICROFACET,
    BSDF_MIRROR,
    BSDF_REFRACTION,
    MaterialInfo,
)

N = 4096
RTOL, ATOL = 1e-5, 1e-6
FAMILIES = {
    "diffuse": BSDF_DIFFUSE, "emission": BSDF_EMISSION, "mirror": BSDF_MIRROR,
    "microfacet": BSDF_MICROFACET, "refraction": BSDF_REFRACTION, "glass": BSDF_GLASS,
}


def _close(got, want, name, where=None, frac=1.0):
    """Within RTOL/ATOL on every element, or on ``frac`` of them and within 10x RTOL on all."""
    got, want = np.asarray(got), np.asarray(want)
    if where is not None:
        got, want = got[where], want[where]
    assert got.shape == want.shape, name
    if want.dtype == bool:
        np.testing.assert_array_equal(got, want, err_msg=name)
    elif frac == 1.0:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=name)
    else:
        ok = np.abs(got - want) <= ATOL + RTOL * np.abs(want)
        assert ok.mean() >= frac, (name, ok.mean())
        np.testing.assert_allclose(got, want, rtol=10 * RTOL, atol=ATOL, err_msg=name)


def _materials(cls):
    return [
        cls(bsdf_type=BSDF_DIFFUSE, albedo=np.array([0.7, 0.5, 0.3])),
        cls(bsdf_type=BSDF_EMISSION, radiance=np.array([4.0, 3.0, 2.0])),
        cls(bsdf_type=BSDF_MIRROR, reflectance=np.array([0.9, 0.85, 0.8])),
        cls(bsdf_type=BSDF_MICROFACET, alpha=0.35, eta=np.array([0.2, 0.92, 1.1]), k=np.array([3.9, 2.45, 2.14])),
        cls(bsdf_type=BSDF_REFRACTION, transmittance=np.array([0.95, 0.9, 1.0]), ior=1.33),
        cls(bsdf_type=BSDF_GLASS, transmittance=np.array([1.0, 1.0, 1.0]), reflectance=np.array([1.0, 1.0, 1.0]),
            ior=1.5),
    ]


def _tables():
    j_tab = j_shading.bsdf_to_device(j_build.BSDFTable.from_materials(_materials(JaxMaterial)))
    t_tab = shading.bsdf_to_device(build.BSDFTable.from_materials(_materials(MaterialInfo)), "cpu")
    return j_tab, t_tab


def _dirs(rng, n, upper=0.0):
    """Unit directions; z >= upper... both hemispheres when upper is None."""
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    if upper is not None:
        v[:, 2] = np.abs(v[:, 2]) + upper
        v /= np.linalg.norm(v, axis=1, keepdims=True)
    return v.astype(np.float32)


def _check_sample(got, want, label):
    _close(got.valid, want.valid, f"sample_f {label} valid")
    valid = np.asarray(want.valid)
    assert valid.mean() > 0.3, f"{label}: too few valid samples to compare"
    for name in ("f", "wi", "pdf"):
        _close(getattr(got, name), getattr(want, name), f"sample_f {label} {name}", where=valid)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_eval_and_sample_match_jax(family):
    rng = np.random.default_rng(FAMILIES[family])
    j_tab, t_tab = _tables()
    b = np.full(N, FAMILIES[family], np.int32)
    wo = _dirs(rng, N, upper=None)  # both sides: refraction and glass enter and exit
    wi_neg = -_dirs(rng, N, upper=None)
    u = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    for families in (None, tuple(sorted(FAMILIES.values()))):
        want = j_shading.eval_f(j_tab, jnp.asarray(b), jnp.asarray(wi_neg), jnp.asarray(wo), families=families)
        got = shading.eval_f(t_tab, torch.as_tensor(b), torch.as_tensor(wi_neg), torch.as_tensor(wo), families=families)
        _close(got, want, f"eval_f {family}")
        want = j_shading.sample_f(j_tab, jnp.asarray(b), jnp.asarray(wo), jnp.asarray(u), families=families)
        got = shading.sample_f(t_tab, torch.as_tensor(b), torch.as_tensor(wo), torch.as_tensor(u), families=families)
        _check_sample(got, want, family)
    # the scene's own families only, as make_settings specializes them
    own = (FAMILIES[family],)
    want = j_shading.sample_f(j_tab, jnp.asarray(b), jnp.asarray(wo), jnp.asarray(u), families=own)
    got = shading.sample_f(t_tab, torch.as_tensor(b), torch.as_tensor(wo), torch.as_tensor(u), families=own)
    _check_sample(got, want, family + " specialized")
    _close(shading.is_delta(t_tab, torch.as_tensor(b)), j_shading.is_delta(j_tab, jnp.asarray(b)), "is_delta")
    _close(shading.get_emission(t_tab, torch.as_tensor(b)), j_shading.get_emission(j_tab, jnp.asarray(b)), "emission")


def _light_table(mod):
    table = mod.LightTable(
        light_type=np.array([mod.LT_DIRECTIONAL, mod.LT_POINT, mod.LT_SPOT, mod.LT_AREA, mod.LT_HEMISPHERE], np.int32),
        radiance=np.array([[1.3, 1.1, 0.6], [9, 9, 10], [5, 4, 3], [6, 6, 6], [0.2, 0.3, 0.4]], np.float32),
        position=np.array([[0.3, 0.5, 0.8], [1, 2, 3], [0.5, 1.9, 0.2], [0, 1.98, 0], [0, 0, 0]], np.float32),
        direction=np.array([[0.3, 0.5, 0.8], [0, 0, 0], [0, -0.94, -0.34], [0, -1, 0], [0, 0, 0]], np.float32),
        dim_x=np.array([[0, 0, 0], [0, 0, 0], [np.cos(np.radians(40)), 2.0, 0], [-0.5, 0, 0], [0, 0, 0]], np.float32),
        dim_y=np.array([[0, 0, 0], [0, 0, 0], [0, 0, 0], [0, 0, -0.5], [0, 0, 0]], np.float32),
        area=np.array([0, 0, 0, 0.25, 0], np.float32),
        is_delta=np.array([True, True, True, False, False]),
    )
    table.direction[0] /= np.linalg.norm(table.direction[0])
    mod.add_sphere_light(table, (0.2, 1.5, -0.3), 0.2, (3.0, 3.0, 2.5))
    tris = np.array([
        [[-0.3, 1.95, -0.3], [0.3, 1.95, -0.3], [0.3, 1.95, 0.3]],
        [[-0.3, 1.95, -0.3], [-0.3, 1.95, -0.3], [0.3, 1.95, 0.3]],  # zero area: a repeated CDF entry
        [[-0.3, 1.95, -0.3], [0.3, 1.95, 0.3], [-0.3, 1.95, 0.3]],
        [[0.5, 0.2, -0.9], [0.9, 0.2, -0.9], [0.5, 0.9, -0.9]],
    ], np.float32)
    mod.add_mesh_light(table, tris[:3], (2.0, 2.0, 1.5))
    mod.add_mesh_light(table, tris[3:], (1.0, 0.5, 0.5))
    return table


def _light_inputs(table, rng, n=N):
    p = rng.uniform(-0.9, 0.9, (n, 3)).astype(np.float32)
    p[:, 1] = rng.uniform(0.0, 1.8, n)
    u = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    cdf = table.mesh_tri_cdf
    u[: len(cdf), 0] = cdf  # u0 exactly on each CDF entry: ties of the pick
    u[len(cdf) : 2 * len(cdf), 0] = np.nextafter(cdf, np.float32(0))
    return p, u


def test_sample_light_static_matches_jax():
    j_table, t_table = _light_table(j_build), _light_table(build)
    rng = np.random.default_rng(11)
    p, u = _light_inputs(t_table, rng)
    j_arr, t_arr = j_lights.lights_to_device(j_table), lights.lights_to_device(t_table, "cpu")
    for row, code in enumerate(t_table.light_type.tolist()):
        want = j_lights.sample_light_static(j_arr, row, code, jnp.asarray(p), jnp.asarray(u))
        got = lights.sample_light_static(t_arr, row, code, torch.as_tensor(p), torch.as_tensor(u))
        for name in ("radiance", "wi", "dist", "pdf"):
            frac = 0.999 if (code == build.LT_SPHERE and name == "pdf") else 1.0
            _close(getattr(got, name), getattr(want, name), f"light row {row} (type {code}) {name}", frac=frac)


@pytest.mark.parametrize("present", ["all", "specialized"])
def test_sample_light_matches_jax(present):
    """The generic per-lane sampler over a random row per lane, every type in one batch."""
    j_table, t_table = _light_table(j_build), _light_table(build)
    rng = np.random.default_rng(12)
    p, u = _light_inputs(t_table, rng)
    li = rng.integers(0, len(t_table.light_type), N).astype(np.int32)
    types = tuple(sorted(set(t_table.light_type.tolist()))) if present == "specialized" else None
    j_arr, t_arr = j_lights.lights_to_device(j_table), lights.lights_to_device(t_table, "cpu")
    want = j_lights.sample_light(j_arr, jnp.asarray(li), jnp.asarray(p), jnp.asarray(u), types_present=types)
    got = lights.sample_light(t_arr, torch.as_tensor(li), torch.as_tensor(p), torch.as_tensor(u), types_present=types)
    for name in ("radiance", "wi", "dist", "pdf"):
        _close(getattr(got, name), getattr(want, name), f"sample_light {name}", frac=0.999 if name == "pdf" else 1.0)


def test_environment_light_is_refused():
    """An LT_ENV row is refused only without its map; ``make_settings`` plans it like an area light."""
    table = _light_table(build)
    t_arr = lights.lights_to_device(table, "cpu")
    with pytest.raises(ValueError, match="environment map"):
        lights.sample_light_static(t_arr, 0, lights.LT_ENV, torch.zeros(4, 3), torch.zeros(4, 2))
    with pytest.raises(ValueError, match="environment map"):
        lights.sample_light(t_arr, torch.zeros(4, dtype=torch.int32), torch.zeros(4, 3), torch.zeros(4, 2),
                            types_present=(lights.LT_ENV,))
    table.light_type[0] = lights.LT_ENV
    table.is_delta[0] = False
    settings = make_settings(table, ns_area_light=3)
    assert settings.light_slots[:3] == (0, 0, 0) and settings.light_slot_types[:3] == (lights.LT_ENV,) * 3


def test_stale_specialization_is_refused():
    """A caller's light_types / bsdf_families that misses a code of the tables raises (path.py:147-162)."""
    table = _light_table(build)
    bsdfs = build.BSDFTable.from_materials(_materials(MaterialInfo))
    settings = make_settings(table, bsdf_table=bsdfs, ns_area_light=2)
    assert settings.light_types == tuple(sorted(set(table.light_type.tolist())))
    assert settings.bsdf_families == tuple(range(6))
    assert len(settings.light_slots) == 3 + 2 * 5  # delta lights once, the others ns_area_light times
    with pytest.raises(ValueError, match="light_types"):
        make_settings(table, light_types=(build.LT_POINT,))
    with pytest.raises(ValueError, match="bsdf_families"):
        make_settings(table, bsdf_table=bsdfs, bsdf_families=(BSDF_DIFFUSE,))
