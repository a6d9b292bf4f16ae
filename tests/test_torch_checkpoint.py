"""Render checkpoints: an interrupted render resumes to the uninterrupted one, bit for bit.

``Renderer.render(checkpoint_path=)`` saves the film after each tile (the
tiled render) or the accumulators and the active set after each stage (the
adaptive render), with a fingerprint of the render.  A render is
interrupted here by making the wavefront call raise after some calls, as a
crash would; the next render with the same file resumes from it.  Every
comparison is exact: the resumed tiles and stages run the same samples on
the same inputs.  A file from another render (another seed or light) or
an unreadable one is not merged into the film, nor is one of a render
under another environment map.  The card's case
(``-m gpu``) runs the same interruptions through the CUDA kernels.
"""

import numpy as np
import pytest
import torch

from lens_flare_tpu_torch import renderer as rmod
from lens_flare_tpu_torch.renderer import Renderer
from lens_flare_tpu_torch.scene.procedural import make_terrain_scene

MODES = {
    # 24 x 20 pixels in 4 tiles of 128 lanes
    "tiled": dict(ns_aa=2, call="render_wavefront", stop_after=2),
    # stages of 2, 2, 4 and 8 samples, the first in 4 tiles; stopped in the second
    "adaptive": dict(ns_aa=16, samples_per_batch=2, max_tolerance=0.05, call="render_batch", stop_after=4),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: tier-1 runs six test processes on the machine's cores, and the
    small tensors here lose most of their time to oversubscribed thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Interrupted(Exception):
    pass


def make(mode, device="cpu", seed=0, envmap=None):
    kw = {k: v for k, v in MODES[mode].items() if k not in ("call", "stop_after")}
    r = Renderer(width=24, height=20, max_ray_depth=3, tile_pixels=128, seed=seed, device=device, envmap=envmap,
                 **kw)
    r.load_flat_scene(make_terrain_scene(8))
    return r


def interrupt(monkeypatch, mode, after=None):
    """Make the mode's wavefront call raise from its ``after``-th call on (default: the mode's)."""
    name = MODES[mode]["call"]
    after = MODES[mode]["stop_after"] if after is None else after
    fn = getattr(rmod, name)
    calls = []

    def wrapped(*args, **kw):
        calls.append(1)
        if len(calls) > after:
            raise Interrupted
        return fn(*args, **kw)

    monkeypatch.setattr(rmod, name, wrapped)
    return calls


def run_interrupted(mode, path, monkeypatch, device="cpu", envmap=None):
    with monkeypatch.context() as m:
        interrupt(m, mode)
        with pytest.raises(Interrupted):
            make(mode, device, envmap=envmap).render(progress=False, checkpoint_path=path)


@pytest.fixture(scope="module", params=list(MODES))
def full(request):
    """(mode, film, counts, rays) of the uninterrupted render."""
    r = make(request.param)
    film, counts = r.render(progress=False)
    return request.param, film, counts, r.stats.total_rays


def test_interrupted_render_resumes_bit_equal(full, tmp_path, monkeypatch, capsys):
    mode, film, counts, rays = full
    path = tmp_path / "ck.npz"
    run_interrupted(mode, path, monkeypatch)
    with np.load(path) as ck:
        assert int(ck["next_tile"]) == 2 if mode == "tiled" else int(ck["stage"]) == 1
    r = make(mode)
    got, got_counts = r.render(progress=True, checkpoint_path=path)
    assert "resuming" in capsys.readouterr().out
    assert torch.equal(got, film) and torch.equal(got_counts, counts)
    assert r.stats.total_rays == rays
    # a completed render's file is its film: nothing is traced again
    monkeypatch.setattr(rmod, MODES[mode]["call"], None)
    again, again_counts = make(mode).render(progress=False, checkpoint_path=path)
    assert torch.equal(again, film) and torch.equal(again_counts, counts)


@pytest.mark.parametrize("damage", ["garbage", "truncated"])
def test_unreadable_checkpoint_is_ignored(full, damage, tmp_path, monkeypatch, capsys):
    mode, film, counts, _ = full
    path = tmp_path / "ck.npz"
    run_interrupted(mode, path, monkeypatch)
    data = path.read_bytes()
    path.write_bytes(b"not a checkpoint" if damage == "garbage" else data[: len(data) // 2])
    got, got_counts = make(mode).render(progress=False, checkpoint_path=path)
    assert "ignoring unreadable checkpoint" in capsys.readouterr().out
    assert torch.equal(got, film) and torch.equal(got_counts, counts)


def test_foreign_checkpoint_is_rejected(full, tmp_path, monkeypatch):
    """A checkpoint of another seed, marked so that a resume would show, leaves the film untouched."""
    mode, _, _, _ = full
    path = tmp_path / "ck.npz"
    run_interrupted(mode, path, monkeypatch)
    with np.load(path) as z:
        data = {k: z[k] for k in z.files}
    data["film"] = data["film"] * 0 + 7.0
    np.savez(path, **data)
    other = make(mode, seed=2)
    want, want_counts = make(mode, seed=2).render(progress=False)
    got, got_counts = other.render(progress=False, checkpoint_path=path)
    assert not (got == 7.0).any()
    assert torch.equal(got, want) and torch.equal(got_counts, want_counts)


def test_checkpoint_under_another_sky_is_rejected(full, tmp_path, monkeypatch):
    """A checkpoint of a render under one environment map does not resume under another: the film
    marked in the file never shows, and the render equals the uninterrupted one under the new sky."""
    mode = full[0]
    sky = np.broadcast_to(np.linspace(1.5, 0.2, 8, dtype=np.float32)[:, None, None], (8, 16, 3)).copy()
    other_sky = sky.copy()
    other_sky[2, 5] += 0.5  # one texel
    path = tmp_path / "ck.npz"
    run_interrupted(mode, path, monkeypatch, envmap=sky)
    with np.load(path) as z:
        data = {k: z[k] for k in z.files}
    data["film"] = data["film"] * 0 + 7.0
    np.savez(path, **data)
    r = make(mode, envmap=other_sky)
    assert r._checkpoint_fingerprint(None) != make(mode, envmap=sky)._checkpoint_fingerprint(None)
    want, want_counts = make(mode, envmap=other_sky).render(progress=False)
    got, got_counts = r.render(progress=False, checkpoint_path=path)
    assert not (got == 7.0).any()
    assert torch.equal(got, want) and torch.equal(got_counts, want_counts)


def test_fingerprint_covers_the_scene_tables():
    r = make("tiled")
    fp = r._checkpoint_fingerprint(None)
    assert fp == make("tiled")._checkpoint_fingerprint(None)
    assert fp != r._checkpoint_fingerprint((0, 0, 8, 8))
    lights = r.bundle.lights
    r.bundle = r.bundle._replace(lights=lights._replace(radiance=lights.radiance * 1.01))
    assert fp != r._checkpoint_fingerprint(None)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("mode", list(MODES))
def test_resume_on_card(mode, cuda_device, tmp_path, monkeypatch):
    film, counts = make(mode, "cuda").render(progress=False)
    path = tmp_path / "ck.npz"
    run_interrupted(mode, path, monkeypatch, "cuda")
    got, got_counts = make(mode, "cuda").render(progress=False, checkpoint_path=path)
    assert got.is_cuda and torch.equal(got, film) and torch.equal(got_counts, counts)
