"""FFT Fraunhofer-diffraction starburst and the irradiance falloff glow.

Counterpart of ``lens_flare_tpu/flare/starburst.py``, which derives why one
FFT of the aperture mask plus an index shuffle equals the reference's
per-pixel DFT (``raytrace_starburst``, ``pathtracer.cpp:947-1041``).  On the
card the per-pixel table lookup is two index selects (rows, then columns),
so the field is read directly instead of assembled from tiled slices.
"""

from __future__ import annotations

import torch

from .. import _rng


def aperture_fft(aperture: torch.Tensor) -> torch.Tensor:
    """|FFT2| of the mask zero-padded to (apW, apW)."""
    h_a, w_a = aperture.shape
    if h_a > w_a:
        raise ValueError("aperture masks must have height <= width")
    if h_a < w_a:
        aperture = torch.nn.functional.pad(aperture, (0, 0, 0, w_a - h_a))
    return torch.abs(torch.fft.fft2(aperture))


def _pow8(x):
    x2 = x * x
    x4 = x2 * x2
    return x4 * x4


def starburst_field(
    fft_mag, total_value, ap_width: int, flare_origin_ns, flare_radiance,
    width: int, height: int, flare_intensity: float = 0.0, flare_radius: float = 0.0,
):
    """Starburst radiance for the whole film -> (H, W, 3) (raytrace_starburst minus falloff)."""
    dev = fft_mag.device
    a = ap_width
    # compute_phase (pathtracer.cpp:917-931)
    lr = torch.ceil(flare_origin_ns[0] * width)
    ud = torch.ceil(flare_origin_ns[1] * height)
    lr_i = int(lr)
    ud_i = int(ud)
    xs = torch.arange(width, device=dev)
    ys = torch.arange(height, device=dev)
    cx = (width + 1) // 2  # first x with x - W/2.0 >= 0
    cy = height // 2 + 1  # first y with H/2.0 - y < 0
    # S[y, x] = |F[Dy mod a, Dx mod a]|, Dx = x - lr + W [x < cx], Dy = ud - y + H [y >= cy]
    dx = xs - lr_i + width * (xs < cx).to(xs.dtype)
    dy = ud_i - ys + height * (ys >= cy).to(ys.dtype)
    base = fft_mag.index_select(0, torch.remainder(dy, a)).index_select(1, torch.remainder(dx, a))
    mag = base / total_value

    # suppression / amplification (pathtracer.cpp:976-992)
    x = xs[None, :].to(torch.float32)
    y = ys[:, None].to(torch.float32)
    dist = torch.sqrt((lr - x) ** 2 + (ud - y) ** 2)
    half_ap = ap_width / 2.0
    far_sel = dist > half_ap
    safe_dist = torch.where(far_sel, torch.clamp_min(dist, 1e-6), 1.0)
    mag_far = _pow8(half_ap / safe_dist) * mag
    near_sel = ~far_sel & (dist <= flare_radius) & (flare_radius > 0)
    safe_mag = torch.where(near_sel, torch.clamp_min(mag, 1e-20), 1.0)
    mag_near = safe_mag ** (dist / max(flare_radius, 1e-12))
    mag = torch.where(far_sel, mag_far, torch.where(near_sel, mag_near, mag))

    intensity = 3.0 - flare_intensity
    if intensity <= 0:
        intensity = 2.0
    return (torch.clamp_min(mag, 0.0) ** intensity)[..., None] * flare_radiance


def irradiance_falloff(
    flare_origins_ns, flare_radiances, width: int, height: int, key,
    radius: float = 5.0, num_samples: int = 16,
):
    """Jittered radial glow (calculate_irradiance_falloff, pathtracer.cpp:1043-1063).

    ``key``: (2,) RNG key; sample j jitters by ``uniform(split(key, 16)[j], (2,))``
    exactly as the JAX package does.
    """
    dev = flare_origins_ns.device
    x = torch.arange(width, device=dev)[None, :]
    y = torch.arange(height, device=dev)[:, None]
    fo_s = flare_origins_ns * torch.tensor([width, height], dtype=torch.float32, device=dev)
    jit = _rng.uniform(_rng.split(key, num_samples), (2,))  # (S, 2)
    total = torch.zeros((height, width, 3), device=dev)
    for j in range(num_samples):
        sx = x + jit[j, 0]
        sy = y + jit[j, 1]
        acc = torch.zeros((height, width, 3), device=dev)
        for f in range(fo_s.shape[0]):
            d = torch.sqrt((fo_s[f, 0] - sx) ** 2 + (fo_s[f, 1] - sy) ** 2)
            r = 1.0 + torch.clamp_min(d - radius, 0.0)
            acc = acc + (r**-1.5)[..., None] * flare_radiances[f]
        total = total + acc
    return total / num_samples
