"""
Device-side image -> map interpolation kernels for :func:`BodyXY.map_img`.

The reference evaluates scipy interpolators per map cell on the CPU
(body_xy.py:1633-1702). Here the per-cell work (the O(map-size) part) runs
on the device as vectorised B-spline tensor-product evaluation:

- ``nearest``: one gather per cell.
- spline degrees 1-3: FITPACK *coefficients* are still solved on the host
  with scipy (an O(image) banded solve, exactly matching the reference's
  ``RectBivariateSpline`` including its knot/boundary conventions and the
  ``s > 0`` smoothing path), then evaluated on device with a de Boor
  tensor-product kernel - the cheap/precise split. Cube inputs solve one
  set of coefficients per frame on host and evaluate all frames in one
  batched device program.

The NaN conventions match the reference exactly and are applied inside the
device program: a map cell is NaN when any of its 4 surrounding integer
pixels is NaN or the sample is outside the pixel-centre grid
(body_xy.py:1855-1866); NaN pixels are in-filled with 3x3 means before the
spline solve (body_xy.py:1871-1904).

The map sample coordinates are constant across frames of an observation,
so their device copies (and the derived validity mask) are cached keyed on
the host arrays' identity - repeated ``map_img`` calls only upload the
per-frame spline coefficients.
"""

from __future__ import annotations

import functools

import numpy as np

_XY_CACHE: dict[tuple, tuple] = {}
_XY_CACHE_MAX = 8


def _device_xy(x_map: np.ndarray, y_map: np.ndarray):
    """
    Device-resident ``(x, y, valid)`` for the map sample coordinates.
    Keyed on the arrays' data pointers; the host arrays are retained in
    the cache entry so the pointers stay valid for the entry's lifetime.
    """
    import jax.numpy as jnp

    key = (
        x_map.ctypes.data, y_map.ctypes.data, x_map.shape, y_map.shape
    )
    hit = _XY_CACHE.get(key)
    if hit is not None:
        return hit[:3]
    valid = np.isfinite(x_map) & np.isfinite(y_map)
    x = np.where(valid, x_map, 0.0).ravel()
    y = np.where(valid, y_map, 0.0).ravel()
    out = (
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(valid.ravel()),
        x_map, y_map,  # keep alive: pins the data pointers in `key`
    )
    if len(_XY_CACHE) >= _XY_CACHE_MAX:
        _XY_CACHE.pop(next(iter(_XY_CACHE)))
    _XY_CACHE[key] = out
    return out[:3]


def _propagate_nan_mask(jnp, x, y, nans):
    """
    4-neighbour NaN / outside-grid test on device (reference
    body_xy.py:1855-1866). ``nans`` is the (ny, nx) image NaN grid;
    x/y are flattened map sample coordinates.
    """
    ny, nx = nans.shape
    outside = (x < 0.0) | (y < 0.0) | (x > nx - 1) | (y > ny - 1)
    x0 = jnp.clip(jnp.floor(x).astype(jnp.int32), 0, nx - 1)
    x1 = jnp.clip(jnp.ceil(x).astype(jnp.int32), 0, nx - 1)
    y0 = jnp.clip(jnp.floor(y).astype(jnp.int32), 0, ny - 1)
    y1 = jnp.clip(jnp.ceil(y).astype(jnp.int32), 0, ny - 1)
    neighbour = (
        nans[y0, x0] | nans[y0, x1] | nans[y1, x0] | nans[y1, x1]
    )
    return outside | neighbour


def _bspline_basis(jnp, t, k, u):
    """
    Non-zero B-spline basis values N_{i-k..i}(u) by the de Boor-Cox
    triangle, plus the knot interval index i. ``t`` is the full FITPACK
    knot vector; evaluation clamps to the valid span like FITPACK.
    """
    i = jnp.clip(
        jnp.searchsorted(t, u, side='right') - 1, k, t.shape[0] - k - 2
    )
    n = [jnp.ones_like(u)]
    for d in range(1, k + 1):
        left = jnp.stack([t[i + 1 - j] for j in range(d, 0, -1)], -1)
        right = jnp.stack([t[i + j] for j in range(1, d + 1)], -1)
        denom = right - left
        denom = jnp.where(denom == 0.0, 1.0, denom)
        term = (u[..., None] - left) / denom
        n_prev = jnp.stack(n, -1)
        n_new = [n_prev[..., 0] * (1.0 - term[..., 0])]
        for j in range(1, d):
            n_new.append(
                n_prev[..., j - 1] * term[..., j - 1]
                + n_prev[..., j] * (1.0 - term[..., j])
            )
        n_new.append(n_prev[..., d - 1] * term[..., d - 1])
        n = n_new
    return jnp.stack(n, -1), i


def _basis_onehot(jnp, lax, t, k: int, u):
    """
    Gather-free de Boor-Cox basis: the interval index comes from a
    broadcast compare-count (== ``searchsorted(t, u, 'right') - 1``) and
    the 2k knots around each sample from ONE one-hot matmul against a
    (n_t, 2k) matrix of shifted knot vectors. This formulation was chosen
    for an accelerator whose gathers are slow; against a native-gather
    evaluator on the H100 it is not measured.
    Returns (basis (S, k+1), interval index i (S,), one-hot of i (S, n_t)).
    """
    n_t = t.shape[0]
    ge = u[:, None] >= t[None, :]
    i = jnp.clip(
        jnp.sum(ge.astype(jnp.int32), axis=1) - 1, k, n_t - k - 2
    )
    oh = (
        jnp.arange(n_t, dtype=jnp.int32)[None, :] == i[:, None]
    ).astype(jnp.float32)
    # tmat[:, m] = t[j + o] for offset o = m + 1 - k, edge-padded (i is
    # clipped so i+o never actually reads the padding)
    tp = jnp.concatenate(
        [jnp.full((k,), t[0]), t, jnp.full((k,), t[-1])]
    )
    tmat = jnp.stack(
        [lax.dynamic_slice(tp, (m + 1,), (n_t,)) for m in range(2 * k)],
        axis=-1,
    )
    knots = jnp.matmul(oh, tmat, precision=lax.Precision.HIGHEST)

    def t_at(o):  # t[i + o], o in [1-k, k]
        return knots[:, o + k - 1]

    n = [jnp.ones_like(u)]
    for d in range(1, k + 1):
        left = jnp.stack([t_at(1 - j) for j in range(d, 0, -1)], -1)
        right = jnp.stack([t_at(j) for j in range(1, d + 1)], -1)
        denom = right - left
        denom = jnp.where(denom == 0.0, 1.0, denom)
        term = (u[..., None] - left) / denom
        n_prev = jnp.stack(n, -1)
        n_new = [n_prev[..., 0] * (1.0 - term[..., 0])]
        for j in range(1, d):
            n_new.append(
                n_prev[..., j - 1] * term[..., j - 1]
                + n_prev[..., j] * (1.0 - term[..., j])
            )
        n_new.append(n_prev[..., d - 1] * term[..., d - 1])
        n = n_new
    return jnp.stack(n, -1), i, oh


def _weight_matrix(jnp, basis, i, k: int, n_c: int):
    """(S, n_c) row-sparse weight matrix W[s, i(s)-k+a] = basis[s, a]."""
    jc = jnp.arange(n_c, dtype=jnp.int32)[None, :]
    w = jnp.zeros((basis.shape[0], n_c), jnp.float32)
    for a in range(k + 1):
        w = w + basis[:, a : a + 1] * (
            jc == (i - k + a)[:, None]
        ).astype(jnp.float32)
    return w


#: Above this many coefficients per axis the one-hot weight matrices get
#: bandwidth-bound; fall back to the gather evaluator.
_ONEHOT_MAX_COEFFS = 1024

#: largest source side served by the fully device-resident s=0 branch
#: (one-time host inversion of the dense collocation matrices: ~seconds
#: at 2048, prohibitive past it). The tiled one-hot contraction handles
#: grids this size, so 2048-class navigated observations stay on the
#: device instead of falling to the host-FITPACK path.
_DEVICE_SOLVE_MAX = 2048

#: Tiled-window sampling (same scheme as ops/pchip_device.py): 2D maps
#: are cut into _TILE x _TILE point tiles whose samples hit a localized
#: patch of the coefficient grid, so the one-hot contractions run
#: against a dynamic window instead of the full grid. Engaged for grids
#: above _TILING_MIN_CELLS coefficients; tiles whose footprint exceeds
#: the window fall back to the full-grid contraction via lax.cond.
_TILE = 64
_WIN = 256
_TILING_MIN_CELLS = 160_000


def _use_tiling(n_cy: int, n_cx: int, out_shape: tuple | None) -> bool:
    """
    Single source of truth for engaging the tiled-window contraction:
    a 2D sample field at least one tile big, against a coefficient grid
    either large in total (full-grid weight matrices would dominate the
    contraction) or long on one axis (past the one-hot gate, where the
    untiled weight matrices get bandwidth-bound). ``pick_eval`` and
    ``eval_all`` MUST agree, else a grid routes to the one-hot
    evaluator but contracts untiled against the full grid.
    """
    return (
        out_shape is not None
        and len(out_shape) == 2
        and out_shape[0] * out_shape[1] >= _TILE * _TILE
        and (
            n_cy * n_cx > _TILING_MIN_CELLS
            or max(n_cy, n_cx) > _ONEHOT_MAX_COEFFS
        )
    )


def _make_onehot_eval(kx: int, ky: int, batched: bool,
                      propagate_nan: bool, out_shape: tuple | None = None):
    """
    Build the shared gather-free evaluation body: ``(ty, tx, c2, nanf, y,
    x, valid) -> flat values`` with ``c2`` the (batched) f32 coefficient
    grid and ``nanf`` the f32 NaN-indicator grid. Used by both the
    host-coefficient (`_spline_eval_onehot_fn`) and device-solve
    (`_spline_solve_eval_fn`) jit programs.

    ``out_shape``: static 2D shape of the sample field, enabling the
    tiled-window contraction for large coefficient grids (see _TILE).
    """
    import jax
    import jax.numpy as jnp
    from jax import lax

    def build_weights(ty, tx, y, x, n_cy, n_cx, cy_off, cx_off):
        """One-hot spline weight matrices over a coefficient window
        (``n_cy/n_cx`` wide, offset ``cy_off/cx_off``)."""
        yc = jnp.clip(y, ty[ky], ty[-ky - 1])
        xc = jnp.clip(x, tx[kx], tx[-kx - 1])
        by, iy, _ = _basis_onehot(jnp, lax, ty, ky, yc)
        bx, ix, _ = _basis_onehot(jnp, lax, tx, kx, xc)
        wy = _weight_matrix(jnp, by, iy - cy_off, ky, n_cy)
        wx = _weight_matrix(jnp, bx, ix - cx_off, kx, n_cx)
        return wy, wx, iy, ix

    def build_nan_indicators(y, x, ny_i, nx_i, ny_off, nx_off,
                             ny_full, nx_full):
        """4-neighbour indicator matrices over an image window
        (``ny_i/nx_i`` wide, offset ``ny_off/nx_off``); clips against
        the FULL image extent."""
        y0 = jnp.clip(jnp.floor(y).astype(jnp.int32), 0, ny_full - 1)
        y1 = jnp.clip(jnp.ceil(y).astype(jnp.int32), 0, ny_full - 1)
        x0 = jnp.clip(jnp.floor(x).astype(jnp.int32), 0, nx_full - 1)
        x1 = jnp.clip(jnp.ceil(x).astype(jnp.int32), 0, nx_full - 1)
        jy = jnp.arange(ny_i, dtype=jnp.int32)[None, :] + ny_off
        jx = jnp.arange(nx_i, dtype=jnp.int32)[None, :] + nx_off
        uy = (
            (jy == y0[:, None]) | (jy == y1[:, None])
        ).astype(jnp.float32)
        ux = (
            (jx == x0[:, None]) | (jx == x1[:, None])
        ).astype(jnp.float32)
        outside = (
            (x < 0.0) | (y < 0.0) | (x > nx_full - 1) | (y > ny_full - 1)
        )
        return uy, ux, outside, (y0, y1, x0, x1)

    def contract(c2, nanf, wy, wx, uy, ux, outside, valid):
        def per_frame(c2_f, nanf_f):
            rows = jnp.matmul(wy, c2_f, precision=lax.Precision.HIGHEST)
            val = jnp.sum(rows * wx, axis=-1)
            m = valid
            if propagate_nan:
                cnt = jnp.sum(
                    jnp.matmul(
                        uy, nanf_f, precision=lax.Precision.HIGHEST
                    ) * ux,
                    axis=-1,
                )
                m = m & ~(outside | (cnt > 0.5))
            return jnp.where(m, val, jnp.nan)

        if batched:
            return jax.vmap(per_frame)(c2, nanf)
        return per_frame(c2, nanf)

    def chunk_eval(ty, tx, c2, nanf, y, x, valid):
        # c2: (..., n_cy, n_cx) f32; nanf: (..., ny_i, nx_i) f32
        n_cy = ty.shape[0] - ky - 1
        n_cx = tx.shape[0] - kx - 1
        wy, wx, _, _ = build_weights(ty, tx, y, x, n_cy, n_cx, 0, 0)
        uy = ux = outside = None
        if propagate_nan:
            ny_i, nx_i = nanf.shape[-2:]
            uy, ux, outside, _ = build_nan_indicators(
                y, x, ny_i, nx_i, 0, 0, ny_i, nx_i
            )
        return contract(c2, nanf, wy, wx, uy, ux, outside, valid)

    def tile_eval(ty64, tx64, c2, nanf, y64, x64, valid):
        # ``ty64``/``y64`` etc. arrive in float64: the basis recurrence
        # runs on DIFFERENCES (u - t[i]), which cancel catastrophically
        # in f32 at large pixel coordinates (~3e-5 px at a 500-px grid,
        # growing linearly). Each tile therefore shifts coordinates AND
        # knots by the tile's coordinate floor in f64 first - window-
        # local magnitudes make the f32 basis exact to ~1e-8 regardless
        # of grid size.
        n_cy = ty64.shape[0] - ky - 1
        n_cx = tx64.shape[0] - kx - 1
        ny_i, nx_i = nanf.shape[-2:]
        w_cy = min(_WIN, n_cy)
        w_cx = min(_WIN, n_cx)
        w_ny = min(_WIN, ny_i)
        w_nx = min(_WIN, nx_i)

        big64 = jnp.float64(n_cy + n_cx + ny_i + nx_i)
        s_y = jnp.floor(jnp.min(jnp.where(valid, y64, big64)))
        s_x = jnp.floor(jnp.min(jnp.where(valid, x64, big64)))
        y = (y64 - s_y).astype(jnp.float32)
        x = (x64 - s_x).astype(jnp.float32)
        ty = (ty64 - s_y).astype(jnp.float32)
        tx = (tx64 - s_x).astype(jnp.float32)

        # Knot interval indices decide the coefficient footprint
        yc = jnp.clip(y, ty[ky], ty[-ky - 1])
        xc = jnp.clip(x, tx[kx], tx[-kx - 1])
        by, iy, _ = _basis_onehot(jnp, lax, ty, ky, yc)
        bx, ix, _ = _basis_onehot(jnp, lax, tx, kx, xc)
        big = jnp.int32(n_cy + n_cx + ny_i + nx_i)

        def tmin(v, care):
            return jnp.min(jnp.where(care, v, big))

        def tmax(v, care):
            return jnp.max(jnp.where(care, v, -1))

        care = valid
        oy = jnp.clip(tmin(iy, care) - ky, 0, n_cy - w_cy)
        ox = jnp.clip(tmin(ix, care) - kx, 0, n_cx - w_cx)
        fits = (
            (tmax(iy, care) <= oy + w_cy - 1)
            & (tmax(ix, care) <= ox + w_cx - 1)
        )
        # Unshifted f32 coordinates for image-grid (NaN) indexing and for
        # the full-grid fallback (same values the untiled path uses)
        yg = y64.astype(jnp.float32)
        xg = x64.astype(jnp.float32)
        if propagate_nan:
            _, _, outside, (y0, y1, x0, x1) = build_nan_indicators(
                yg, xg, 1, 1, 0, 0, ny_i, nx_i
            )
            care_n = care & ~outside
            oyn = jnp.clip(tmin(y0, care_n), 0, ny_i - w_ny)
            oxn = jnp.clip(tmin(x0, care_n), 0, nx_i - w_nx)
            fits = fits & (
                (tmax(y1, care_n) <= oyn + w_ny - 1)
                & (tmax(x1, care_n) <= oxn + w_nx - 1)
            )
        else:
            oyn = oxn = jnp.int32(0)

        def windowed(_):
            wy = _weight_matrix(jnp, by, iy - oy, ky, w_cy)
            wx = _weight_matrix(jnp, bx, ix - ox, kx, w_cx)
            if batched:
                # index dtypes must match: a literal 0 would be int64
                c2_w = lax.dynamic_slice(
                    c2, (jnp.zeros_like(oy), oy, ox),
                    (c2.shape[0], w_cy, w_cx),
                )
            else:
                c2_w = lax.dynamic_slice(c2, (oy, ox), (w_cy, w_cx))
            uy = ux = outside_w = None
            nanf_w = nanf
            if propagate_nan:
                uy, ux, outside_w, _ = build_nan_indicators(
                    yg, xg, w_ny, w_nx, oyn, oxn, ny_i, nx_i
                )
                if batched:
                    nanf_w = lax.dynamic_slice(
                        nanf, (jnp.zeros_like(oyn), oyn, oxn),
                        (nanf.shape[0], w_ny, w_nx),
                    )
                else:
                    nanf_w = lax.dynamic_slice(
                        nanf, (oyn, oxn), (w_ny, w_nx)
                    )
            return contract(
                c2_w, nanf_w, wy, wx, uy, ux, outside_w, valid
            )

        def full(_):
            return chunk_eval(
                ty64.astype(jnp.float32), tx64.astype(jnp.float32),
                c2, nanf, yg, xg, valid,
            )

        return lax.cond(fits, windowed, full, None)

    n_tiled_cells = 0
    if out_shape is not None and len(out_shape) == 2:
        n_tiled_cells = out_shape[0] * out_shape[1]

    def eval_all(ty, tx, c2, nanf, y, x, valid):
        n = y.shape[0]
        n_cy = c2.shape[-2]
        n_cx = c2.shape[-1]
        n_c = max(n_cy, n_cx)

        if (
            n_tiled_cells >= _TILE * _TILE
            and _use_tiling(n_cy, n_cx, out_shape)
        ):
            # keep f64 coordinates/knots: tile_eval re-centres them per
            # tile before its f32 cast
            ty64 = ty.astype(jnp.float64)
            tx64 = tx.astype(jnp.float64)
            y64 = y.astype(jnp.float64)
            x64 = x.astype(jnp.float64)
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

            out = lax.map(
                lambda a: tile_eval(
                    ty64, tx64, c2, nanf, a[0], a[1], a[2]
                ),
                (to_tiles(y64, 0.0), to_tiles(x64, 0.0),
                 to_tiles(valid, False)),
            )
            # out: (n_tiles, [frames,] T*T) -> [frames,] my*mx
            if batched:
                out = jnp.moveaxis(out, 1, 0)
            out = (
                out.reshape(
                    out.shape[:-2]
                    + (my_p // _TILE, mx_p // _TILE, _TILE, _TILE)
                )
                .swapaxes(-3, -2)
                .reshape(out.shape[:-2] + (my_p, mx_p))[..., :my, :mx]
            )
            return out.reshape(out.shape[:-2] + (my * mx,)).astype(
                jnp.float32
            )

        ty = ty.astype(jnp.float32)
        tx = tx.astype(jnp.float32)
        y = y.astype(jnp.float32)
        x = x.astype(jnp.float32)
        # ~0.5 GB for the largest (frames, chunk, n_c) intermediate:
        # small grids evaluate in few chunks (lax.map serializes chunks,
        # so fewer/bigger chunks keep the device busy), while cube inputs
        # shrink the chunk so the per-frame row matrices still fit
        n_frames = c2.shape[0] if batched else 1
        chunk = int(
            min(max(n, 1), max(8192, (1 << 27) // (n_c * n_frames)))
        )
        n_chunks = -(-n // chunk)
        pad = n_chunks * chunk - n
        yp = jnp.pad(y, (0, pad)).reshape(n_chunks, chunk)
        xp = jnp.pad(x, (0, pad)).reshape(n_chunks, chunk)
        vp = jnp.pad(valid, (0, pad)).reshape(n_chunks, chunk)
        out = lax.map(
            lambda a: chunk_eval(ty, tx, c2, nanf, a[0], a[1], a[2]),
            (yp, xp, vp),
        )
        # lax.map stacks chunks on axis 0; batched frames land on axis 1
        if batched:
            out = jnp.moveaxis(out, 1, 0).reshape(c2.shape[0], -1)
        else:
            out = out.reshape(-1)
        return out[..., :n].astype(jnp.float32)

    return eval_all


@functools.lru_cache(maxsize=None)
def _spline_eval_onehot_fn(kx: int, ky: int, batched: bool,
                           propagate_nan: bool,
                           out_shape: tuple | None = None):
    """
    Jitted gather-free spline evaluator (matmul formulation).

    The scattered-gather form (``_spline_eval_fn``) costs ~50 gathers of
    N map samples. Here every lookup becomes a one-hot/weighted matmul
    against the small coefficient grid:

        val[s] = sum_ab By[s,a] Bx[s,b] C[iy(s)-ky+a, ix(s)-kx+b]
               = rowsum( (Wy @ C) * Wx )

    with Wy/Wx row-sparse (k+1 nonzeros). The 4-neighbour NaN test is the
    same trick against the NaN-indicator grid. Samples stream in chunks
    (lax.map) to bound the (chunk, n_c) weight matrices; for cubes the
    weights are built once per chunk and every frame rides the same pair
    of matmuls. Matmuls run precision=HIGHEST (bf16 passes would corrupt
    f32 data values).
    """
    import jax
    import jax.numpy as jnp

    eval_all = _make_onehot_eval(kx, ky, batched, propagate_nan, out_shape)

    def fn(ty, tx, c, nans, y, x, valid):
        n_cy = ty.shape[0] - ky - 1
        n_cx = tx.shape[0] - kx - 1
        c2 = c.astype(jnp.float32).reshape(c.shape[:-1] + (n_cy, n_cx))
        nanf = nans.astype(jnp.float32)
        return eval_all(ty, tx, c2, nanf, y, x, valid)

    return jax.jit(fn)


def _infill_device(jnp, frame):
    """
    Device replica of the reference's NaN-infill preparation
    (body_xy.py:1871-1904 / :func:`..interp
    .replace_nans_with_interpolated_values`): non-finite cells with at
    least one finite cell in their clipped 3x3 neighbourhood take the
    neighbourhood nanmean; remaining non-finite cells take the global
    nanmedian (0 if the frame has no finite cells). Returns ``(cleaned,
    nan_grid)``.

    Fully-finite frames (the common streaming case) skip the whole
    preparation at run time via ``lax.cond`` - the nanmedian is a sort
    of the full frame, which can dwarf the spline solve itself. NOTE:
    only effective outside ``vmap``
    (which lowers cond to select, executing both branches); batched
    callers map frames with ``lax.map``.
    """
    from jax import lax

    def passthrough(_):
        return frame, jnp.zeros(frame.shape, bool)

    def clean(_):
        finite = jnp.isfinite(frame)
        imgn = jnp.where(finite, frame, jnp.nan)
        med = jnp.where(jnp.any(finite), jnp.nanmedian(imgn), 0.0)
        z = jnp.where(finite, frame, 0.0)
        g = finite.astype(frame.dtype)
        zp = jnp.pad(z, 1)
        gp = jnp.pad(g, 1)
        ny, nx = frame.shape
        s = jnp.zeros_like(frame)
        cnt = jnp.zeros_like(frame)
        for dy in range(3):
            for dx in range(3):
                s = s + zp[dy : dy + ny, dx : dx + nx]
                cnt = cnt + gp[dy : dy + ny, dx : dx + nx]
        nb_mean = s / jnp.where(cnt > 0, cnt, 1.0)
        cleaned = jnp.where(
            finite, frame, jnp.where(cnt > 0, nb_mean, med)
        )
        # Propagation mask is the *NaN* grid (reference body_xy.py:1668
        # uses np.isnan, so infs are infilled for the solve but not
        # propagated)
        return cleaned, jnp.isnan(frame)

    return lax.cond(
        jnp.all(jnp.isfinite(frame)), passthrough, clean, None
    )


@functools.lru_cache(maxsize=None)
def _grid_spline_solver(ny: int, nx: int, kx: int, ky: int):
    """
    Per-grid staging for the device-resident coefficient solve: FITPACK
    knots for the s=0 interpolating spline on the regular pixel grid plus
    the dense inverses of the two 1-D B-spline collocation matrices, kept
    on device. ``C = Ainv_y @ img @ Ainv_x.T`` then reproduces scipy's
    ``RectBivariateSpline(s=0)`` coefficients to rounding error, so the
    per-frame host work and coefficient upload disappear entirely.
    """
    import jax.numpy as jnp
    import scipy.interpolate

    probe = np.zeros((ny, nx))
    spline = scipy.interpolate.RectBivariateSpline(
        np.arange(ny), np.arange(nx), probe, kx=ky, ky=kx, s=0
    )
    ty, tx = spline.get_knots()
    ay = scipy.interpolate.BSpline.design_matrix(
        np.arange(ny, dtype=float), ty, ky, extrapolate=False
    ).toarray()
    ax = scipy.interpolate.BSpline.design_matrix(
        np.arange(nx, dtype=float), tx, kx, extrapolate=False
    ).toarray()
    return (
        jnp.asarray(ty), jnp.asarray(tx),
        jnp.asarray(np.linalg.inv(ay)), jnp.asarray(np.linalg.inv(ax)),
    )


@functools.lru_cache(maxsize=None)
def _spline_solve_eval_fn(kx: int, ky: int, batched: bool,
                          propagate_nan: bool,
                          out_shape: tuple | None = None):
    """
    Jitted end-to-end map-reprojection program: NaN infill, collocation
    solve (two small matmuls against the staged inverses) and the
    gather-free spline evaluation all happen on device. The only
    per-frame host->device transfer is the raw image itself, and no host
    FITPACK solve sits on the per-frame critical path.
    """
    import jax
    import jax.numpy as jnp
    from jax import lax

    eval_all = _make_onehot_eval(kx, ky, batched, propagate_nan, out_shape)

    def _solve(ainv_y, ainv_x, frames):
        def prep(frame):
            cleaned, nans = _infill_device(jnp, frame)
            c2 = jnp.matmul(
                ainv_y.astype(frame.dtype),
                jnp.matmul(
                    cleaned, ainv_x.T.astype(frame.dtype),
                    precision=lax.Precision.HIGHEST,
                ),
                precision=lax.Precision.HIGHEST,
            )
            return c2.astype(jnp.float32), nans.astype(jnp.float32)

        # lax.map, not vmap: keeps _infill_device's NaN-free fast path
        # a real branch (vmap lowers cond to select - both sides run,
        # including the full-frame nanmedian sort)
        return lax.map(prep, frames) if batched else prep(frames)

    def fn(ty, tx, ainv_y, ainv_x, frames, y, x, valid):
        c2, nanf = _solve(ainv_y, ainv_x, frames)
        return eval_all(ty, tx, c2, nanf, y, x, valid)

    return jax.jit(fn)


@functools.lru_cache(maxsize=None)
def _spline_eval_fn(kx: int, ky: int, batched: bool, propagate_nan: bool):
    """Jitted masked de Boor tensor-product evaluator."""
    import jax
    import jax.numpy as jnp

    def eval_one(ty, tx, c, nans, y, x, valid):
        # f32 evaluation throughout: a ~1e-5 px sample-position rounding
        # times O(1/px) image gradients sits below the 2e-5 comparison
        # tolerance
        ty = ty.astype(jnp.float32)
        tx = tx.astype(jnp.float32)
        c = c.astype(jnp.float32)
        y = y.astype(jnp.float32)
        x = x.astype(jnp.float32)
        # FITPACK's fpbisp clamps evaluation coordinates into the knot
        # domain (scipy .ev returns the boundary value outside the grid);
        # without this the boundary polynomial would extrapolate. The
        # NaN-propagation mask below tests the UNCLAMPED coordinates.
        yc = jnp.clip(y, ty[ky], ty[-ky - 1])
        xc = jnp.clip(x, tx[kx], tx[-kx - 1])
        ny_b, iy = _bspline_basis(jnp, ty, ky, yc)
        nx_b, ix = _bspline_basis(jnp, tx, kx, xc)
        n_cx = tx.shape[0] - kx - 1
        val = jnp.zeros_like(y)
        for a in range(ky + 1):
            row = iy - ky + a
            for b in range(kx + 1):
                col = ix - kx + b
                val = val + ny_b[..., a] * nx_b[..., b] * c[
                    row * n_cx + col
                ]
        mask = valid
        if propagate_nan:
            mask = mask & ~_propagate_nan_mask(jnp, x, y, nans)
        # f32 result: halves the device->host transfer; 6e-8 relative
        # rounding of *data* values is far below any science use of a
        # reprojected image
        return jnp.where(mask, val, jnp.nan).astype(jnp.float32)

    if batched:
        def fn(ty, tx, c, nans, y, x, valid):
            return jax.vmap(
                lambda cf, nf: eval_one(ty, tx, cf, nf, y, x, valid)
            )(c, nans)
    else:
        fn = eval_one

    return jax.jit(fn)


def _fitpack_coeffs(img, kx, ky, spline_smoothing, warn_nan):
    """Host-side FITPACK solve (reference body_xy.py:1673-1680)."""
    import scipy.interpolate

    from .interp import replace_nans_with_interpolated_values

    cleaned = replace_nans_with_interpolated_values(img, warn_nan)
    spline = scipy.interpolate.RectBivariateSpline(
        np.arange(img.shape[0]),
        np.arange(img.shape[1]),
        cleaned,
        kx=ky,  # scipy's first axis is our y
        ky=kx,
        s=spline_smoothing,
    )
    ty, tx = spline.get_knots()
    c = spline.get_coeffs()
    return ty, tx, c


def spline_interpolation_device(
    img, x_map, y_map, *, interpolation, warn_nan: bool,
    propagate_nan: bool, spline_smoothing: float, as_numpy: bool = True,
):
    """
    Device-evaluated spline reprojection. ``img`` may be 2D ``(ny, nx)``
    or a cube ``(nz, ny, nx)`` (one host coefficient solve per frame, one
    batched device evaluation). Returns an array shaped like the map (or
    ``(nz,) + map``); values carry float32 precision (relative 6e-8).
    """
    import jax
    import jax.numpy as jnp

    if isinstance(interpolation, int):
        kx = ky = interpolation
    else:
        # Reference semantics (body_xy.py:1673-1680 -> RectBivariateSpline
        # with scipy's first axis = image rows): tuple[0] is the degree
        # along image ROWS. This module's kx is the degree along image x
        # (columns), so the tuple swaps on entry.
        ky, kx = interpolation

    cube = img.ndim == 3
    frames = img if cube else img[None]
    nz = frames.shape[0]
    x_dev, y_dev, valid_dev = _device_xy(x_map, y_map)

    ny_i, nx_i = img.shape[-2:]
    if spline_smoothing == 0 and max(ny_i, nx_i) <= _DEVICE_SOLVE_MAX:
        # Fully device-resident path (s=0, the default): NaN infill,
        # coefficient solve and evaluation in ONE jitted program; the only
        # per-call upload is the raw frame. The host-FITPACK path below
        # remains for smoothing (adaptive knots) and very large grids.
        if warn_nan:
            for frame in frames:
                if not np.isfinite(frame).all():
                    print(
                        'Warning, image contains NaN values which will '
                        'be corrected'
                    )
        ty, tx, ainv_y, ainv_x = _grid_spline_solver(ny_i, nx_i, kx, ky)
        fn = _spline_solve_eval_fn(
            kx, ky, cube, propagate_nan,
            tuple(x_map.shape) if x_map.ndim == 2 else None,
        )
        vals = fn(
            ty, tx, ainv_y, ainv_x, jnp.asarray(img, dtype=jnp.float64),
            y_dev, x_dev, valid_dev,
        )
        vals = vals.reshape(img.shape[:-2] + x_map.shape)
        if not propagate_nan:
            # Host semantics: a frame with no finite values maps to NaN
            all_nan = np.array(
                [not np.isfinite(f).any() for f in frames], dtype=bool
            )
            if all_nan.any():
                mask = jnp.asarray(
                    all_nan if cube else all_nan[0]
                )
                vals = jnp.where(
                    mask[..., None, None] if cube else mask,
                    jnp.nan, vals,
                )
        if as_numpy:
            return np.asarray(vals)
        return vals

    def pick_eval(ty, tx, batched):
        n_cy = ty.shape[0] - ky - 1
        n_cx = tx.shape[0] - kx - 1
        out_shape = tuple(x_map.shape) if x_map.ndim == 2 else None
        # The tiled-window contraction keeps the one-hot evaluator
        # viable for arbitrarily large coefficient grids: weight matrices
        # are window-wide, not grid-wide. The predicate MUST be the same
        # one eval_all applies, else a large grid would contract untiled.
        if (
            max(n_cy, n_cx) <= _ONEHOT_MAX_COEFFS
            or _use_tiling(n_cy, n_cx, out_shape)
        ):
            return _spline_eval_onehot_fn(
                kx, ky, batched, propagate_nan, out_shape
            )
        return _spline_eval_fn(kx, ky, batched, propagate_nan)

    # host-FITPACK branch (smoothing / very large grids): numpy-side
    # per-frame solves, so materialise device-resident inputs up front
    img = np.asarray(img)
    frames = img if cube else img[None]

    results = np.full((nz,) + x_map.shape, np.nan)
    coeffs: list[np.ndarray] = []
    nan_grids: list[np.ndarray] = []
    knots = None
    good: list[int] = []
    singles: list[int] = []
    for i, frame in enumerate(frames):
        if np.all(np.isnan(frame)):
            continue
        ty, tx, c = _fitpack_coeffs(
            frame, kx, ky, spline_smoothing, warn_nan
        )
        if knots is None:
            knots = (ty, tx)
        elif not (
            np.array_equal(ty, knots[0]) and np.array_equal(tx, knots[1])
        ):
            # FITPACK places knots adaptively when smoothing: frames can
            # share knot counts but not positions, so compare values
            # Different smoothing outcomes per frame: rare; evaluate alone
            fn = pick_eval(ty, tx, False)
            dev = jax.device_put((ty, tx, c, np.isnan(frame)))
            vals = fn(*dev, y_dev, x_dev, valid_dev)
            results[i] = np.asarray(vals).reshape(x_map.shape)
            singles.append(i)
            continue
        coeffs.append(c)
        nan_grids.append(np.isnan(frame))
        good.append(i)

    if good:
        if len(good) == 1:
            fn = pick_eval(knots[0], knots[1], False)
            dev = jax.device_put(
                (knots[0], knots[1], coeffs[0], nan_grids[0])
            )
            vals = fn(*dev, y_dev, x_dev, valid_dev).reshape(
                (1,) + x_map.shape
            )
        else:
            fn = pick_eval(knots[0], knots[1], True)
            dev = jax.device_put(
                (knots[0], knots[1], np.stack(coeffs),
                 np.stack(nan_grids))
            )
            vals = fn(*dev, y_dev, x_dev, valid_dev).reshape(
                (len(good),) + x_map.shape
            )
        if not as_numpy and not singles and len(good) == nz:
            # every frame evaluated on device with shared knots: hand the
            # device array straight back (no device->host copy)
            return vals if cube else vals[0]
        vals = np.asarray(vals)
        for j, i in enumerate(good):
            results[i] = vals[j]

    return results if cube else results[0]


@functools.lru_cache(maxsize=None)
def _nearest_fn(batched: bool):
    import jax
    import jax.numpy as jnp

    def one(img, y, x, valid):
        xi = jnp.clip(jnp.round(x).astype(jnp.int32), 0, img.shape[-1] - 1)
        yi = jnp.clip(jnp.round(y).astype(jnp.int32), 0, img.shape[-2] - 1)
        return jnp.where(valid, img[yi, xi], jnp.nan)

    if batched:
        def fn(img, y, x, valid):
            return jax.vmap(lambda f: one(f, y, x, valid))(img)
    else:
        fn = one
    return jax.jit(fn)


def nearest_interpolation_device(img, x_map, y_map, as_numpy: bool = True):
    """Nearest-pixel gather on device (reference body_xy.py:1633-1649)."""
    import jax.numpy as jnp

    x_dev, y_dev, valid_dev = _device_xy(x_map, y_map)
    cube = img.ndim == 3
    fn = _nearest_fn(cube)
    out = fn(jnp.asarray(img), y_dev, x_dev, valid_dev)
    shape = (img.shape[0],) + x_map.shape if cube else x_map.shape
    if as_numpy:
        return np.asarray(out).reshape(shape)
    return out.reshape(shape)
