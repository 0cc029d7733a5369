"""
Device-resident 'smooth' (PCHIP) map interpolation.

Replicates the reference's monotone-cubic mapping mode (reference
body_xy.py:1704-1853: separable row/column PCHIP oversampling of the
image followed by linear interpolation at the map sample points) as one
jitted device program, replacing the scipy PchipInterpolator /
RegularGridInterpolator host path on the default route.

The data-dependent part of PCHIP - each row interpolates over only its
*finite* cells, with NaN gaps bridged by irregular-spacing monotone
cubics - is expressed with fixed shapes:

- nearest-finite-neighbour indices/values/derivatives come from
  ``lax.associative_scan`` with a "last valid wins" combiner (no gathers);
- the Fritsch-Carlson derivative rules (scipy's ``_find_derivatives``
  weighted harmonic mean + one-sided edge formula with its monotonicity
  clamps) are evaluated branchlessly for every cell and masked;
- evaluation positions are a static ``linspace`` whose enclosing cells
  are known at trace time, so per-cell quantities move to the oversampled
  grid with ``jnp.repeat`` (static total) instead of dynamic gathers;
- the final map-sample stage is the same chunked one-hot/weight-matrix
  bilinear evaluation used by the spline path, with scipy's NaN semantics
  (any referenced corner NaN -> NaN) reproduced via indicator matmuls.
"""

from __future__ import annotations

import functools
import math

import numpy as np

from .interp_device import _TILE, _WIN, _device_xy, _use_tiling


def _last_valid_scan(lax, jnp, valid, payloads, axis: int, reverse: bool):
    """
    Inclusive scan returning, for each position, the payload of the
    nearest valid position at-or-before it (at-or-after with
    ``reverse=True``), plus whether one exists.
    """

    def combine(a, b):
        # b is the later element in scan order: it wins where valid
        av = a[0]
        bv = b[0]
        out = [bv | av]
        for ap, bp in zip(a[1:], b[1:]):
            out.append(jnp.where(bv, bp, ap))
        return tuple(out)

    return lax.associative_scan(
        combine, (valid, *payloads), axis=axis, reverse=reverse
    )


def _shift(jnp, arr, axis: int, offset: int, fill):
    """Shift along ``axis`` by ``offset`` (+1 = towards higher index),
    filling vacated cells with ``fill``."""
    if offset == 0:
        return arr
    n = arr.shape[axis]
    pad = [(0, 0)] * arr.ndim
    if offset > 0:
        pad[axis] = (offset, 0)
        sl = [slice(None)] * arr.ndim
        sl[axis] = slice(0, n)
    else:
        pad[axis] = (0, -offset)
        sl = [slice(None)] * arr.ndim
        sl[axis] = slice(-offset, n - offset)
    return jnp.pad(arr, pad, constant_values=fill)[tuple(sl)]


def _edge_derivative(jnp, h0, d0, h1, d1):
    """scipy PchipInterpolator._edge_case: one-sided three-point estimate
    with the Fritsch-Carlson monotonicity clamps."""
    d = ((2.0 * h0 + h1) * d0 - h0 * d1) / (h0 + h1)
    sign_flip = jnp.sign(d) != jnp.sign(d0)
    over = (jnp.sign(d0) != jnp.sign(d1)) & (jnp.abs(d) > 3.0 * jnp.abs(d0))
    d = jnp.where(sign_flip, 0.0, d)
    d = jnp.where(over, 3.0 * d0, d)
    return d


def _pchip_axis(jnp, lax, values, n_eval: int, k_rep: int):
    """
    PCHIP each row of ``values`` (..., n) over its finite cells and
    evaluate on the static ``linspace(0, n-1, n_eval)`` grid (whose step
    is ``1/k_rep`` of a cell; ``n_eval == (n-1)*k_rep + 1``). Rows with
    fewer than two finite cells evaluate to NaN (scipy behaviour), as do
    positions outside a row's finite span (``extrapolate=False``).
    """
    n = values.shape[-1]
    axis = values.ndim - 1
    idx = jnp.arange(n, dtype=values.dtype)
    idx = jnp.broadcast_to(idx, values.shape)
    finite = jnp.isfinite(values)
    v = jnp.where(finite, values, 0.0)

    # nearest finite at-or-before / at-or-after each cell
    fv, f_idx, f_val = _last_valid_scan(
        lax, jnp, finite, (idx, v), axis, reverse=False
    )
    bv, b_idx, b_val = _last_valid_scan(
        lax, jnp, finite, (idx, v), axis, reverse=True
    )
    # strictly-before / strictly-after neighbours (for derivative stencils)
    pv = _shift(jnp, fv, axis, 1, False)
    p_idx = _shift(jnp, f_idx, axis, 1, 0.0)
    p_val = _shift(jnp, f_val, axis, 1, 0.0)
    nv = _shift(jnp, bv, axis, -1, False)
    n_idx = _shift(jnp, b_idx, axis, -1, 0.0)
    n_val = _shift(jnp, b_val, axis, -1, 0.0)

    # per-finite-cell interval widths and slopes
    h_prev = jnp.where(pv, idx - p_idx, 1.0)
    d_prev = jnp.where(pv, (v - p_val) / h_prev, 0.0)
    h_next = jnp.where(nv, n_idx - idx, 1.0)
    d_next = jnp.where(nv, (n_val - v) / h_next, 0.0)

    # second-interval data for the one-sided edge stencils: the (h, d) of
    # the *neighbouring finite cell's* outward interval, again by scans
    _, nn_h, nn_d, nn_has = _last_valid_scan(
        lax, jnp, finite, (h_next, d_next, nv), axis, reverse=True
    )
    nn_h = _shift(jnp, nn_h, axis, -1, 1.0)
    nn_d = _shift(jnp, nn_d, axis, -1, 0.0)
    nn_has = _shift(jnp, nn_has, axis, -1, False)
    _, pp_h, pp_d, pp_has = _last_valid_scan(
        lax, jnp, finite, (h_prev, d_prev, pv), axis, reverse=False
    )
    pp_h = _shift(jnp, pp_h, axis, 1, 1.0)
    pp_d = _shift(jnp, pp_d, axis, 1, 0.0)
    pp_has = _shift(jnp, pp_has, axis, 1, False)

    # Fritsch-Carlson interior derivative (scipy _find_derivatives):
    # weighted harmonic mean where slopes share a sign, else 0
    w1 = 2.0 * h_next + h_prev
    w2 = h_next + 2.0 * h_prev
    same_sign = (d_prev * d_next) > 0.0
    denom = jnp.where(same_sign, w1 / jnp.where(d_prev == 0, 1.0, d_prev)
                      + w2 / jnp.where(d_next == 0, 1.0, d_next), 1.0)
    d_interior = jnp.where(same_sign, (w1 + w2) / denom, 0.0)

    # edge derivatives (missing second interval falls back to its own,
    # which reduces the stencil to the 2-point linear slope)
    d_first = _edge_derivative(
        jnp, h_next, d_next,
        jnp.where(nn_has, nn_h, h_next), jnp.where(nn_has, nn_d, d_next),
    )
    d_last = _edge_derivative(
        jnp, h_prev, d_prev,
        jnp.where(pp_has, pp_h, h_prev), jnp.where(pp_has, pp_d, d_prev),
    )
    deriv = jnp.where(
        pv & nv, d_interior,
        jnp.where(nv, d_first, jnp.where(pv, d_last, 0.0)),
    )

    # segment data at every cell: left = nearest finite at-or-before,
    # right = nearest finite at-or-after (consecutive finite cells bracket
    # every evaluation position by construction). The index/value lanes
    # are exactly the first scan pair's results; only derivatives need a
    # further scan.
    _, l_der = _last_valid_scan(
        lax, jnp, finite, (deriv,), axis, reverse=False
    )
    _, r_der = _last_valid_scan(
        lax, jnp, finite, (deriv,), axis, reverse=True
    )
    l_idx, l_val, has_l = f_idx, f_val, fv
    r_idx, r_val, has_r = b_idx, b_val, bv

    # move per-cell segment data to the oversampled grid: positions
    # linspace(0, n-1, n_eval) fall in cell floor(x) -> static repeats
    reps_floor = np.full(n, k_rep)
    reps_floor[-1] = 1
    reps_ceil = np.full(n, k_rep)
    reps_ceil[0] = 1

    def on_eval_floor(a):
        return jnp.repeat(a, reps_floor, axis=axis,
                          total_repeat_length=n_eval)

    def on_eval_ceil(a):
        return jnp.repeat(a, reps_ceil, axis=axis,
                          total_repeat_length=n_eval)

    xl = on_eval_floor(l_idx)
    fl = on_eval_floor(l_val)
    dl = on_eval_floor(l_der)
    ok_l = on_eval_floor(has_l)
    xr = on_eval_ceil(r_idx)
    fr = on_eval_ceil(r_val)
    dr = on_eval_ceil(r_der)
    ok_r = on_eval_ceil(has_r)

    xs = jnp.linspace(0.0, float(n - 1), n_eval, dtype=values.dtype)
    xs = jnp.broadcast_to(xs, values.shape[:-1] + (n_eval,))

    h = xr - xl
    degenerate = h == 0.0
    h_safe = jnp.where(degenerate, 1.0, h)
    t = (xs - xl) / h_safe
    t2 = t * t
    t3 = t2 * t
    hermite = (
        fl * (2.0 * t3 - 3.0 * t2 + 1.0)
        + h_safe * dl * (t3 - 2.0 * t2 + t)
        + fr * (-2.0 * t3 + 3.0 * t2)
        + h_safe * dr * (t3 - t2)
    )
    result = jnp.where(degenerate, fl, hermite)
    result = jnp.where(ok_l & ok_r, result, jnp.nan)
    # scipy skips rows with < 2 finite points entirely
    enough = jnp.sum(finite, axis=axis, keepdims=True) >= 2
    return jnp.where(enough, result, jnp.nan)


# Tiled-window sampling shares _TILE/_WIN and the _use_tiling gate with
# interp_device (single source of truth): maps are cut into _TILE x _TILE
# point tiles; each tile's samples hit a localized patch of the
# oversampled grid, so its one-hot matmuls contract against a
# _WIN x _WIN dynamic window instead of the full grid (8-10x fewer
# matmul flops at the default 5x oversampling). Tiles whose footprint
# exceeds the window fall back, via lax.cond, to direct gathers: common
# at detector sizes (a 1024^2 source at 0.25 deg, where a 64-cell tile
# spans ~600 oversampled pixels), where the full-grid one-hot contraction
# took ~0.8 s per frame on an H100.


@functools.lru_cache(maxsize=64)
def _smooth_fn(ny: int, nx: int, ny_b: int, nx_b: int,
               ky_rep: int, kx_rep: int, propagate_nan: bool,
               out_shape: tuple):
    """
    Jitted end-to-end 'smooth' program for one (image-shape, box-size,
    oversampling) configuration: box slice, row PCHIP, column PCHIP,
    tiled/chunked bilinear sampling with scipy's NaN-corner semantics,
    and the 4-neighbour NaN propagation mask.

    The box ORIGIN (iy0, ix0) is a traced argument of the returned
    function: disc fitting and GUI scrubbing translate the map's pixel
    bounding box every call, and keying the compile cache on absolute
    coordinates caused a fresh multi-second XLA compile per disc
    position. Translation only shifts the slice origin and the
    sample-coordinate offsets, so one program per box SIZE suffices.
    """
    import jax
    import jax.numpy as jnp
    from jax import lax

    n_xs = (nx_b - 1) * kx_rep + 1
    n_ys = (ny_b - 1) * ky_rep + 1
    x_step = (nx_b - 1) / (n_xs - 1) if n_xs > 1 else 1.0
    y_step = (ny_b - 1) / (n_ys - 1) if n_ys > 1 else 1.0

    def bilinear(grid_f32, grid_nan, ybl, xbl, mask):
        """
        Bilinear one-hot contraction of ``grid_f32``/``grid_nan`` (shapes
        (NY, NX)) at local box coordinates ``ybl``/``xbl``; scipy
        RegularGridInterpolator semantics (any NaN corner -> NaN).
        ``mask`` already encodes validity + the global inside test.
        """
        NY, NX = grid_f32.shape
        iy = jnp.clip(jnp.floor(ybl), 0, max(NY - 2, 0))
        ix = jnp.clip(jnp.floor(xbl), 0, max(NX - 2, 0))
        ty = (ybl - iy).astype(jnp.float32)
        tx = (xbl - ix).astype(jnp.float32)
        iyi = iy.astype(jnp.int32)
        ixi = ix.astype(jnp.int32)
        jy = jnp.arange(NY, dtype=jnp.int32)[None, :]
        jx = jnp.arange(NX, dtype=jnp.int32)[None, :]
        oh_y0 = (jy == iyi[:, None]).astype(jnp.float32)
        oh_y1 = (jy == (iyi + 1)[:, None]).astype(jnp.float32)
        oh_x0 = (jx == ixi[:, None]).astype(jnp.float32)
        oh_x1 = (jx == (ixi + 1)[:, None]).astype(jnp.float32)
        wy = oh_y0 * (1.0 - ty)[:, None] + oh_y1 * ty[:, None]
        wx = oh_x0 * (1.0 - tx)[:, None] + oh_x1 * tx[:, None]
        rows = jnp.matmul(wy, grid_f32, precision=lax.Precision.HIGHEST)
        val = jnp.sum(rows * wx, axis=-1)
        # scipy's linear stage hits all 2x2 corners regardless of weight:
        # any NaN corner -> NaN
        cy = oh_y0 + oh_y1
        cx = oh_x0 + oh_x1
        nan_hit = jnp.sum(
            jnp.matmul(cy, grid_nan, precision=lax.Precision.HIGHEST) * cx,
            axis=-1,
        ) > 0.5
        return jnp.where(mask & ~nan_hit, val, jnp.nan)

    def bilinear_gather(grid_f32, grid_nan, ybl, xbl, mask):
        """:func:`bilinear` by direct gathers of the four corners: the
        fallback for tiles whose samples spread wider than the window,
        where a full-grid one-hot contraction costs O(samples x grid)."""
        NY, NX = grid_f32.shape
        iy = jnp.clip(jnp.floor(ybl), 0, max(NY - 2, 0)).astype(jnp.int32)
        ix = jnp.clip(jnp.floor(xbl), 0, max(NX - 2, 0)).astype(jnp.int32)
        ty = (ybl - iy).astype(jnp.float32)
        tx = (xbl - ix).astype(jnp.float32)
        iy1 = jnp.minimum(iy + 1, NY - 1)
        ix1 = jnp.minimum(ix + 1, NX - 1)
        val = (
            (grid_f32[iy, ix] * (1.0 - tx) + grid_f32[iy, ix1] * tx)
            * (1.0 - ty)
            + (grid_f32[iy1, ix] * (1.0 - tx) + grid_f32[iy1, ix1] * tx) * ty
        )
        nan_hit = (
            grid_nan[iy, ix] + grid_nan[iy, ix1] + grid_nan[iy1, ix]
            + grid_nan[iy1, ix1]
        ) > 0.5
        return jnp.where(mask & ~nan_hit, val, jnp.nan)

    def nan_indicators(y, x, n_wy: int, n_wx: int, oyn, oxn):
        """4-neighbour indicator matrices on the ORIGINAL image grid over
        an (n_wy, n_wx) window at offset (oyn, oxn); bounds clip against
        the full image."""
        y0n = jnp.clip(jnp.floor(y).astype(jnp.int32), 0, ny - 1)
        y1n = jnp.clip(jnp.ceil(y).astype(jnp.int32), 0, ny - 1)
        x0n = jnp.clip(jnp.floor(x).astype(jnp.int32), 0, nx - 1)
        x1n = jnp.clip(jnp.ceil(x).astype(jnp.int32), 0, nx - 1)
        jyn = jnp.arange(n_wy, dtype=jnp.int32)[None, :] + oyn
        jxn = jnp.arange(n_wx, dtype=jnp.int32)[None, :] + oxn
        uy = (
            (jyn == y0n[:, None]) | (jyn == y1n[:, None])
        ).astype(jnp.float32)
        ux = (
            (jxn == x0n[:, None]) | (jxn == x1n[:, None])
        ).astype(jnp.float32)
        outside = (x < 0.0) | (y < 0.0) | (x > nx - 1) | (y > ny - 1)
        return uy, ux, outside, (y0n, y1n, x0n, x1n)

    def nan_mask(uy, ux, outside, img_nan_w, mask):
        cnt = jnp.sum(
            jnp.matmul(uy, img_nan_w, precision=lax.Precision.HIGHEST)
            * ux,
            axis=-1,
        )
        return mask & ~(outside | (cnt > 0.5))

    def sample_chunk(grid_f32, grid_nan, iy0f, ix0f, y, x, valid,
                     img_nan):
        yb = (y - iy0f) / y_step
        xb = (x - ix0f) / x_step
        inside = (
            (yb >= 0.0) & (yb <= n_ys - 1) & (xb >= 0.0) & (xb <= n_xs - 1)
        )
        mask = valid & inside
        if propagate_nan:
            uy, ux, outside, _ = nan_indicators(y, x, ny, nx, 0, 0)
            mask = nan_mask(uy, ux, outside, img_nan, mask)
        return bilinear(grid_f32, grid_nan, yb, xb, mask)

    w_y = min(_WIN, n_ys)
    w_x = min(_WIN, n_xs)
    w_ny = min(_WIN, ny)
    w_nx = min(_WIN, nx)

    def sample_tile(grid_f32, grid_nan, iy0f, ix0f, y, x, valid,
                    img_nan):
        yb = (y - iy0f) / y_step
        xb = (x - ix0f) / x_step
        inside = (
            (yb >= 0.0) & (yb <= n_ys - 1) & (xb >= 0.0) & (xb <= n_xs - 1)
        )
        care = valid & inside
        big = float(n_ys + n_xs + 10)
        oy = jnp.clip(
            jnp.floor(jnp.min(jnp.where(care, yb, big))).astype(jnp.int32)
            - 1,
            0, n_ys - w_y,
        )
        ox = jnp.clip(
            jnp.floor(jnp.min(jnp.where(care, xb, big))).astype(jnp.int32)
            - 1,
            0, n_xs - w_x,
        )
        iy_g = jnp.clip(jnp.floor(yb), 0, max(n_ys - 2, 0)).astype(
            jnp.int32
        )
        ix_g = jnp.clip(jnp.floor(xb), 0, max(n_xs - 2, 0)).astype(
            jnp.int32
        )
        ok = (
            (iy_g >= oy) & (iy_g <= oy + w_y - 2)
            & (ix_g >= ox) & (ix_g <= ox + w_x - 2)
        )
        fits = jnp.all(jnp.where(care, ok, True))
        # the image-grid NaN test windows the same way (its footprint is
        # the tile's pixel coordinates, local by construction)
        if propagate_nan:
            _, _, outside, (y0n, y1n, x0n, x1n) = nan_indicators(
                y, x, 1, 1, 0, 0
            )
            care_n = care & ~outside
            big_i = jnp.int32(ny + nx)
            oyn = jnp.clip(
                jnp.min(jnp.where(care_n, y0n, big_i)), 0, ny - w_ny
            )
            oxn = jnp.clip(
                jnp.min(jnp.where(care_n, x0n, big_i)), 0, nx - w_nx
            )
            fits = fits & jnp.all(jnp.where(
                care_n,
                (y1n <= oyn + w_ny - 1) & (x1n <= oxn + w_nx - 1),
                True,
            ))
        else:
            oyn = oxn = jnp.int32(0)

        def windowed(_):
            mask = care
            if propagate_nan:
                uy, ux, outside_w, _ = nan_indicators(
                    y, x, w_ny, w_nx, oyn, oxn
                )
                img_nan_w = lax.dynamic_slice(
                    img_nan, (oyn, oxn), (w_ny, w_nx)
                )
                mask = nan_mask(uy, ux, outside_w, img_nan_w, mask)
            gw = lax.dynamic_slice(grid_f32, (oy, ox), (w_y, w_x))
            gnw = lax.dynamic_slice(grid_nan, (oy, ox), (w_y, w_x))
            return bilinear(gw, gnw, yb - oy, xb - ox, mask)

        def full(_):
            mask = care
            if propagate_nan:
                _, _, outside_f, (y0g, y1g, x0g, x1g) = nan_indicators(
                    y, x, 1, 1, 0, 0
                )
                hit = (
                    img_nan[y0g, x0g] + img_nan[y0g, x1g]
                    + img_nan[y1g, x0g] + img_nan[y1g, x1g]
                ) > 0.5
                mask = mask & ~(outside_f | hit)
            return bilinear_gather(grid_f32, grid_nan, yb, xb, mask)

        return lax.cond(fits, windowed, full, None)

    use_tiles = _use_tiling(n_ys, n_xs, tuple(out_shape))

    def fn(img, iy0, ix0, y, x, valid):
        iy0f = iy0.astype(jnp.float64)
        ix0f = ix0.astype(jnp.float64)
        box = lax.dynamic_slice(
            img, (iy0, ix0), (ny_b, nx_b)
        ).astype(jnp.float64)
        intermediate = _pchip_axis(jnp, lax, box, n_xs, kx_rep)
        final = _pchip_axis(
            jnp, lax, jnp.swapaxes(intermediate, 0, 1), n_ys, ky_rep
        )
        final = jnp.swapaxes(final, 0, 1)  # (n_ys, n_xs)
        grid_nan = jnp.isnan(final).astype(jnp.float32)
        grid_f32 = jnp.where(jnp.isnan(final), 0.0, final).astype(
            jnp.float32
        )
        img_nan = jnp.isnan(img).astype(jnp.float32)

        y = y.astype(jnp.float64)
        x = x.astype(jnp.float64)
        n = y.shape[0]

        if use_tiles:
            my, mx = out_shape
            my_p = -(-my // _TILE) * _TILE
            mx_p = -(-mx // _TILE) * _TILE

            def to_tiles(a, fill):
                a2 = jnp.pad(
                    a.reshape(my, mx),
                    ((0, my_p - my), (0, mx_p - mx)),
                    constant_values=fill,
                )
                return (
                    a2.reshape(my_p // _TILE, _TILE, mx_p // _TILE, _TILE)
                    .swapaxes(1, 2)
                    .reshape(-1, _TILE * _TILE)
                )

            yt = to_tiles(y, 0.0)
            xt = to_tiles(x, 0.0)
            vt = to_tiles(valid, False)
            out = lax.map(
                lambda a: sample_tile(
                    grid_f32, grid_nan, iy0f, ix0f, a[0], a[1], a[2],
                    img_nan,
                ),
                (yt, xt, vt),
            )
            out = (
                out.reshape(my_p // _TILE, mx_p // _TILE, _TILE, _TILE)
                .swapaxes(1, 2)
                .reshape(my_p, mx_p)[:my, :mx]
            )
            return out.reshape(-1).astype(jnp.float32)

        n_c = max(n_ys, n_xs)
        chunk = int(min(max(n, 1), max(8192, (1 << 27) // n_c)))
        n_chunks = -(-n // chunk)
        pad = n_chunks * chunk - n
        yp = jnp.pad(y, (0, pad)).reshape(n_chunks, chunk)
        xp = jnp.pad(x, (0, pad)).reshape(n_chunks, chunk)
        vp = jnp.pad(valid, (0, pad)).reshape(n_chunks, chunk)
        out = lax.map(
            lambda a: sample_chunk(
                grid_f32, grid_nan, iy0f, ix0f, a[0], a[1], a[2], img_nan
            ),
            (yp, xp, vp),
        )
        return out.reshape(-1)[:n].astype(jnp.float32)

    return jax.jit(fn)


#: cached map-extent pixel bounding boxes (see smooth_interpolation_device)
_BOX_CACHE: dict[tuple, tuple] = {}


def smooth_interpolation_device(
    img, x_map, y_map, *, propagate_nan: bool, oversample_by: int,
    max_oversampled_img_size: int, limit_padding: float = 5.0,
    as_numpy: bool = True,
):
    """
    Device-evaluated 'smooth' (PCHIP) reprojection of an image frame, or
    of a whole cube in one batched program (``img`` with a leading frame
    axis is vmapped over frames, exactly like the spline/nearest cube
    paths). Semantics follow the host implementation
    (:func:`..interp.smooth_interpolation` / reference
    body_xy.py:1704-1853): the image is restricted to the map's padded
    pixel-coordinate bounding box, PCHIP-oversampled separably, and
    sampled linearly at the map coordinates.
    """
    import jax.numpy as jnp

    img = np.asarray(img)
    is_cube = img.ndim == 3
    ny, nx = img.shape[-2:]
    out_shape = (
        (img.shape[0],) + tuple(x_map.shape) if is_cube else x_map.shape
    )
    # map-extent scans (nanmin/nanmax over the full map arrays) cached
    # per map: at ~4 full-array host passes they would otherwise
    # dominate a streamed per-frame call (~15 ms of numpy per frame for
    # a 720x1440 map vs ~4 ms of device work)
    box_key = (
        x_map.ctypes.data, y_map.ctypes.data, x_map.shape, ny, nx,
        limit_padding,
    )
    hit = _BOX_CACHE.get(box_key)
    if hit is None:
        any_finite = bool(
            np.any(np.isfinite(x_map) & np.isfinite(y_map))
        )
        if any_finite:
            xlim = (np.nanmin(x_map), np.nanmax(x_map))
            ylim = (np.nanmin(y_map), np.nanmax(y_map))
            ix0 = max(0, int(math.ceil(xlim[0] - limit_padding)))
            ix1 = min(nx, int(math.floor(xlim[1] + limit_padding)) + 1)
            iy0 = max(0, int(math.ceil(ylim[0] - limit_padding)))
            iy1 = min(ny, int(math.floor(ylim[1] + limit_padding)) + 1)
        else:
            ix0 = ix1 = iy0 = iy1 = 0
        if len(_BOX_CACHE) >= 8:
            _BOX_CACHE.pop(next(iter(_BOX_CACHE)))
        # keep the maps alive: they pin the data pointers in the key
        hit = (any_finite, ix0, ix1, iy0, iy1, x_map, y_map)
        _BOX_CACHE[box_key] = hit
    any_finite, ix0, ix1, iy0, iy1 = hit[:5]
    if not any_finite or np.all(np.isnan(img)):
        result = np.full(out_shape, np.nan)
        return result if as_numpy else jnp.asarray(result, jnp.float32)
    if ix1 - ix0 < 2 or iy1 - iy0 < 2:
        # degenerate box: the host path would find < 2 usable points in
        # one direction and leave the map NaN
        result = np.full(out_shape, np.nan)
        return result if as_numpy else jnp.asarray(result, jnp.float32)

    def pick_rep(n_box: int) -> int:
        for k in range(oversample_by, 1, -1):
            if n_box * k - (k - 1) <= max_oversampled_img_size:
                return k
        return 1

    kx_rep = pick_rep(ix1 - ix0)
    ky_rep = pick_rep(iy1 - iy0)

    img_dev = jnp.asarray(img, dtype=jnp.float64)
    x_dev, y_dev, valid_dev = _device_xy(x_map, y_map)
    fn = _smooth_fn(
        ny, nx, iy1 - iy0, ix1 - ix0, ky_rep, kx_rep, propagate_nan,
        tuple(x_map.shape),
    )
    args = (jnp.int32(iy0), jnp.int32(ix0), y_dev, x_dev, valid_dev)
    if is_cube:
        import jax

        vals = jax.vmap(lambda im: fn(im, *args))(img_dev)
    else:
        vals = fn(img_dev, *args)
    vals = vals.reshape(out_shape)
    if as_numpy:
        # match the host implementation's float64 output
        return np.asarray(vals, dtype=np.float64)
    return vals
