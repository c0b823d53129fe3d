"""Shared resampling helpers.

Ports of rtxdi/RtxdiHelpers.hlsli and the neighbor/validity math from
rtxdi/RtxdiMath.hlsli, vectorized over pixel arrays.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from raytracer2.params import RTXDI_RESERVOIR_BLOCK_SIZE

RTXDI_TILE_SIZE_IN_PIXELS = 16  # (InitialSamplingFunctions.hlsli:25-27)

# Bias-correction modes (RtxdiParameters.h:28-36)
BIAS_CORRECTION_OFF = 0
BIAS_CORRECTION_BASIC = 1
BIAS_CORRECTION_PAIRWISE = 2
BIAS_CORRECTION_RAY_TRACED = 3
# The host's default GI/DI bias mode is 2 (pairwise, main.rs:263,279) — for
# the GI path modes >= 1 all take the "basic" MIS normalization branch and
# only mode == 3 adds the bias-correction visibility ray
# (GIResamplingFunctions.hlsli:320-356).


def compare_relative_difference(reference, candidate, threshold):
    """(RtxdiMath.hlsli:18-21)."""
    return ((threshold <= 0)
            | (jnp.abs(reference - candidate)
               <= threshold * jnp.maximum(reference, candidate)))


def is_valid_neighbor(our_norm, their_norm, our_depth, their_depth,
                      normal_threshold, depth_threshold):
    """Edge-stopping similarity test (RtxdiMath.hlsli:25-29)."""
    ndot = jnp.sum(our_norm * their_norm, axis=-1)
    return ((ndot >= normal_threshold)
            & compare_relative_difference(our_depth, their_depth,
                                          depth_threshold))


def m_factor(q0, q1):
    """Pairwise-MIS M multiplier (RtxdiMath.hlsli:104-109)."""
    r = jnp.clip(jnp.power(jnp.minimum(q1 / jnp.maximum(q0, 1e-30), 1.0), 8.0),
                 0.0, 1.0)
    return jnp.where(q0 <= 0.0, 1.0, r)


def pairwise_mis_weight(w0, w1, m0, m1):
    """Balance-heuristic pairwise MIS weight (RtxdiMath.hlsli:112-117)."""
    denom = m0 * w0 + m1 * w1
    return jnp.where(denom <= 0.0, 0.0,
                     jnp.maximum(0.0, m0 * w0) / jnp.where(denom <= 0.0, 1.0,
                                                           denom))


# ---------------------------------------------------------------------------
# Checkerboard-field pixel decomposition (RtxdiHelpers.hlsli:16-61)
# ---------------------------------------------------------------------------

def is_active_checkerboard_pixel(px, py, previous_frame: bool, field: int):
    """(RtxdiHelpers.hlsli:16-25)."""
    if field == 0:
        return jnp.ones(px.shape, bool)
    return ((px + py + int(previous_frame)) & 1) == (field & 1)


def activate_checkerboard_pixel(px, py, previous_frame: bool, field: int):
    """(RtxdiHelpers.hlsli:27-43). Returns shifted (px, py)."""
    if field == 0:
        return px, py
    active = is_active_checkerboard_pixel(px, py, previous_frame, field)
    if previous_frame:
        shift = field * 2 - 3
        px_new = px + shift
    else:
        px_new = px + jnp.where((py & 1) != 0, 1, -1)
    return jnp.where(active, px, px_new), py


def pixel_pos_to_reservoir_pos(px, py, field: int):
    """(RtxdiHelpers.hlsli:45-51)."""
    if field == 0:
        return px, py
    return px >> 1, py


def reservoir_pos_to_pixel_pos(rx, ry, field: int):
    """(RtxdiHelpers.hlsli:53-61)."""
    if field == 0:
        return rx, ry
    px = rx << 1
    return px + ((ry + field) & 1), ry


def apply_permutation_sampling(px, py, uniform_random_number):
    """(RtxdiHelpers.hlsli:64-73)."""
    ox = (uniform_random_number & 3).astype(jnp.int32)
    oy = ((uniform_random_number >> 2) & 3).astype(jnp.int32)
    px = ((px + ox) ^ 3) - ox
    py = ((py + oy) ^ 3) - oy
    return px, py


def reservoir_position_to_pointer(reservoir_params, rx, ry,
                                  reservoir_array_index):
    """Block-linear reservoir addressing (RtxdiHelpers.hlsli:75-88). The
    rebuild stores reservoirs as [slot, H, W] arrays; this exists for
    byte-layout parity tests and external interop."""
    bs = RTXDI_RESERVOIR_BLOCK_SIZE
    block_x = rx // bs
    block_y = ry // bs
    in_x = rx % bs
    in_y = ry % bs
    return (reservoir_array_index * reservoir_params.reservoir_array_pitch
            + block_y * reservoir_params.reservoir_block_row_pitch
            + block_x * (bs * bs) + in_y * bs + in_x)


def calculate_temporal_resampling_offset(sample_idx, radius):
    """8-point pattern around a pixel (GIResamplingFunctions.hlsli:113-130)."""
    s = sample_idx & 7
    mask2 = (s >> 1) & 1
    mask4 = 1 - ((s >> 2) & 1)
    tmp0 = -1 + 2 * (s & 1)
    tmp1 = 1 - 2 * mask2
    tmp2 = mask4 | mask2
    tmp3 = mask4 | (1 - mask2)
    return tmp0 * tmp2 * radius, tmp0 * tmp1 * tmp3 * radius


def calculate_spatial_resampling_offset(sample_idx, radius, neighbor_offsets,
                                        neighbor_offset_mask):
    """Low-discrepancy disk offset (GIResamplingFunctions.hlsli:132-136)."""
    idx = sample_idx & neighbor_offset_mask
    off = neighbor_offsets[idx] * radius
    return off[..., 0].astype(jnp.int32), off[..., 1].astype(jnp.int32)


def boiling_filter_mask(weight: jax.Array, filter_strength,
                        group_size: int = 16) -> jax.Array:
    """Boiling filter (RtxdiHelpers.hlsli:97-151): kill reservoirs whose
    weight exceeds a multiple of the average nonzero weight in their 16x16
    pixel group. The wave/group-shared reduction becomes a block pooling.
    weight: [H, W]. Returns boolean kill mask."""
    h, w = weight.shape
    pad_h = (-h) % group_size
    pad_w = (-w) % group_size
    wpad = jnp.pad(weight, ((0, pad_h), (0, pad_w)))
    hh, ww = wpad.shape
    blocks = wpad.reshape(hh // group_size, group_size,
                          ww // group_size, group_size)
    wsum = blocks.sum(axis=(1, 3))
    count = (blocks > 0).sum(axis=(1, 3))
    avg = jnp.where(count > 0, wsum / jnp.maximum(count, 1), 0.0)
    avg_full = jnp.repeat(jnp.repeat(avg, group_size, 0), group_size, 1)
    avg_full = avg_full[:h, :w]
    multiplier = 10.0 / jnp.clip(filter_strength, 1e-6, 1.0) - 9.0
    return weight > avg_full * multiplier
