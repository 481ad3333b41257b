"""Bias-per-step capping (reference do_add_hill, lib/edm_bias.cpp:444-526;
flush_bias_buffer, :313-380) by prefix sums, in PyTorch.

Counterpart of ``edm_tpu/ops/prefix_cap.py``.  Deposition is linear in
height and each hill's integral per unit height ``s_k`` is geometry only,
so the reference's sequential hill-by-hill limiter reduces to locating the
prefix-sum crossing of the cap.  ``cap_scan`` repeats a parallel pass per
crossing (virtually always one); the JAX ``lax.while_loop`` becomes a
Python loop here, and each test of its exit condition reads one flag back
to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..grid import device_const


class CapResult(NamedTuple):
    dep_heights: torch.Tensor  # effective deposited height per hill
    defer_heights: torch.Tensor  # remainder pushed to the overflow buffer
    deposited: torch.Tensor  # bool: do_add_hill took the deposit branch
    straddled: torch.Tensor  # bool: partial undo happened
    cum: torch.Tensor  # final temp_hill_cum


def cap_scan(heights, weights, active, cap, cum0) -> CapResult:
    """New-hill capping (do_add_hill with communicate=1,
    edm_bias.cpp:465-523); heights/weights/active (H,) in deposit order,
    ``cum0`` the bias already added this step (the buffer drain).

    Returns the result and the number of host reads it made."""
    dtype = heights.dtype
    dev = heights.device
    N = heights.shape[0]
    cap = device_const(cap, dev, dtype)
    cum = device_const(cum0, dev, dtype)
    idxs = torch.arange(N, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    contrib_all = torch.where(active, heights * weights, zero)

    # cum0 already at/over the cap: every active hill defers whole
    done = cum >= cap
    start = torch.zeros((), dtype=torch.int64, device=dev)
    dep = torch.zeros(N, dtype=dtype, device=dev)
    defer = torch.where(active & done, heights, zero)
    deposited = torch.zeros(N, dtype=torch.bool, device=dev)
    straddled = torch.zeros(N, dtype=torch.bool, device=dev)
    reads = 1
    while not bool(done):
        undec = active & (idxs >= start)
        c = torch.where(undec, contrib_all, zero)
        prefix = cum + torch.cumsum(c, 0)
        prev = prefix - c

        full = undec & (prev < cap) & (prefix <= cap)
        crossing = undec & (prev < cap) & (prefix > cap)
        any_cross = torch.any(crossing)
        k_star = torch.argmax(crossing.to(torch.int8))

        dep = torch.where(full, heights, dep)
        deposited = deposited | full

        h_k = heights[k_star]
        s_k = weights[k_star]
        pre_k = prefix[k_star]
        h_undo = torch.maximum(cap - pre_k, -h_k)
        is_k = any_cross & (idxs == k_star)
        dep = torch.where(is_k, h_k + h_undo, dep)
        defer = torch.where(is_k, -h_undo, defer)
        deposited = deposited | is_k
        straddled = straddled | is_k

        # exact saturation (prefix == cap, no crossing): later hills are
        # buffered whole without touching temp_hill_cum_ (edm_bias.cpp:465,498)
        sat = undec & (prev >= cap)
        cum = torch.where(
            any_cross, pre_k + h_undo * s_k,
            cum + torch.sum(torch.where(full, c, zero)),
        )
        done = ~any_cross | (cum >= cap)
        post = undec & (idxs > k_star) & any_cross
        defer = torch.where(post & done, heights, defer)
        defer = torch.where(sat & ~any_cross, heights, defer)
        start = torch.where(any_cross, k_star + 1, torch.full_like(start, N))
        reads += 1
    return CapResult(dep, defer, deposited, straddled, cum), reads


class DrainResult(NamedTuple):
    dep_heights: torch.Tensor  # (CAP,) effective deposit per slot
    new_heights: torch.Tensor  # (CAP,) post-drain buffer heights
    consumed: torch.Tensor  # bool: slot fully drained
    processed: torch.Tensor  # bool: slot touched this drain
    straddled: torch.Tensor
    bias_added: torch.Tensor  # total bias deposited by the drain


def drain_scan(heights, weights, active, max_bias) -> DrainResult:
    """Overflow-buffer drain (flush_bias_buffer, edm_bias.cpp:313-380): one
    parallel pass that stops at the straddling slot, which keeps its
    un-deposited remainder."""
    zero = torch.zeros((), dtype=heights.dtype, device=heights.device)
    max_bias = device_const(max_bias, heights.device, heights.dtype)
    contrib = torch.where(active, heights * weights, zero)
    prefix = torch.cumsum(contrib, 0)
    prev = prefix - contrib

    # processed iff the running total had not yet exceeded max_bias before
    # it (strict >: equality continues, edm_bias.cpp:334)
    processed = active & (prev <= max_bias)
    straddled = processed & (prefix > max_bias)
    consumed = processed & ~straddled

    h_undo = torch.maximum(max_bias - prefix, -heights)
    dep = torch.where(consumed, heights, torch.where(straddled, heights + h_undo, zero))
    new_h = torch.where(consumed, zero, torch.where(straddled, -h_undo, heights))

    undo_term = torch.sum(torch.where(straddled, h_undo * weights, zero))
    bias_added = torch.sum(torch.where(processed, contrib, zero)) + undo_term
    return DrainResult(dep, new_h, consumed, processed, straddled, bias_added)
