"""PointNet++ point ops on one cloud, (N, C) point-major.

Port of ``nerfdet_tpu/ops/pointnet.py``: ``square_distance``,
``furthest_point_sample`` (the hand-written CUDA kernel K3,
``csrc/furthest_point_sample.cu``, with its plain version),
``ball_query``, ``gather_points``, ``group_points``, ``three_nn``,
``three_interpolate`` and ``interpolation_weights``. Indices are int32,
as in the JAX package; they are widened to int64 only where torch
indexes with them.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import cuda_build


def square_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, 3) x (M, 3) -> (N, M) squared euclidean distances, as the
    JAX expansion ``|a|^2 - 2 a.b + |b|^2`` clamped at 0. The product
    runs in full float32: the entry points turn TF32 off
    (``device.resolve_device``)."""
    a2 = torch.sum(a * a, dim=-1, keepdim=True)
    b2 = torch.sum(b * b, dim=-1, keepdim=True)
    return torch.clamp(a2 - 2.0 * (a @ b.t()) + b2.t(), min=0.0)


def furthest_point_sample_plain(points: torch.Tensor,
                                n_samples: int) -> torch.Tensor:
    """Plain PyTorch version of K3 (same signature and results).

    Iterative farthest-point sampling from index 0: the running minimum
    over steps of the squared distance to the last pick, summed over all
    C columns in column order from 0 (separately rounded subtract,
    multiply and add), then the first index of its maximum
    (``torch.argmax`` documents the first). Returns (n_samples,) int32.
    """
    n, c = points.shape
    pts = points.float()
    cols = [pts[:, k] for k in range(c)]
    out = torch.zeros((n_samples,), dtype=torch.int32, device=pts.device)
    min_dist = torch.full((n,), float("inf"), device=pts.device)
    last = torch.zeros((1,), dtype=torch.long, device=pts.device)
    for i in range(1, n_samples):
        sel = pts.index_select(0, last)[0]
        d = torch.zeros((n,), device=pts.device)
        for k in range(c):
            diff = cols[k] - sel[k]
            d = d + diff * diff
        min_dist = torch.minimum(min_dist, d)
        last = torch.argmax(min_dist).reshape(1)
        out[i] = last[0]
    return out


FPS_CLUSTER_SIZES = (1, 2, 4, 8, 16)  # 16 is above the portable 8
FPS_SMEM_LIMIT = 232448  # opt-in shared memory of an H100 block, bytes
# (the launcher also checks the byte count against the device's own)
FPS_CTA_POINTS = 2048  # points one CTA takes before the cloud spreads


def fps_smem_bytes(c: int, slice_: int) -> int:
    """Shared memory of one K3 CTA holding ``slice_`` points of C
    columns, in bytes: the planes and the running minimum, the first
    pick, the warps' partials and the cluster's 16 slots a step parity
    (the layout in ``csrc/furthest_point_sample.cu``). The launch passes
    this size to the kernel."""
    return 4 * ((c + 1) * slice_ + c + 4 * 32 + 2 * 16 * (c + 2))


def fps_plan(n: int, c: int) -> Tuple[int, int, int]:
    """K3's launch for an (N, C) cloud: (cluster size, points per CTA,
    shared-memory bytes per CTA).

    The smallest cluster whose slices hold at most ``FPS_CTA_POINTS``
    points each and fit a CTA's shared memory; where none does, the
    largest, 16. Raises above what a 16-CTA cluster holds."""
    fits = [k for k in FPS_CLUSTER_SIZES
            if fps_smem_bytes(c, -(-n // k)) <= FPS_SMEM_LIMIT]
    if not fits:
        raise ValueError(
            f"K3 holds the cloud in the shared memory of a 16-CTA cluster: "
            f"N={n} C={c} needs {fps_smem_bytes(c, -(-n // 16))} bytes a "
            f"CTA, above {FPS_SMEM_LIMIT}")
    small = [k for k in fits if -(-n // k) <= FPS_CTA_POINTS]
    k = small[0] if small else fits[-1]
    slice_ = -(-n // k)
    return k, slice_, fps_smem_bytes(c, slice_)


def furthest_point_sample(points: torch.Tensor,
                          n_samples: int) -> torch.Tensor:
    """K3: farthest-point sampling (see ``furthest_point_sample_plain``).

    A CPU tensor takes the plain version. A CUDA tensor launches the
    kernel on a thread-block cluster of ``fps_plan(N, C)[0]`` CTAs, or
    raises where the kernel does not take the input: the cloud must fit
    the cluster's shared memory.
    """
    if points.device.type == "cpu":
        return furthest_point_sample_plain(points, n_samples)
    out = _fps_launch(points, n_samples)
    furthest_point_sample.launches += 1
    return out


furthest_point_sample.launches = 0


def _fps_launch(points, n_samples):
    """Check and launch K3 on the card on the plan's cluster; the launch
    is not counted."""
    if points.device.type != "cuda":
        raise ValueError(f"unsupported device {points.device}")
    if points.dtype != torch.float32:
        raise TypeError(f"points must be float32, got {points.dtype}")
    if points.dim() != 2:
        raise ValueError(f"points must be (N, C), got {tuple(points.shape)}")
    n, c = points.shape
    if not 1 <= n_samples <= n or c < 1:
        raise ValueError(f"need 1 <= n_samples <= N and C >= 1, got "
                         f"N={n} C={c} n_samples={n_samples}")
    k, slice_, smem = fps_plan(n, c)
    lib = _lib()
    dev = points.device
    planes = points.t().contiguous()  # (C, N): coalesced loads
    out = torch.empty((n_samples,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):  # the attributes and launch act on it
        err = lib.furthest_point_sample(
            planes.data_ptr(), out.data_ptr(), n, c, n_samples, k, slice_,
            smem, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"furthest_point_sample kernel launch failed: "
                           f"cudaError {err}")
    return out


def _lib():
    lib = cuda_build.load("furthest_point_sample")
    fn = lib.furthest_point_sample
    if fn.argtypes is None:  # pointers must not pass as 32-bit ints
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, i, i, i, i, i, ctypes.c_longlong, p]
        fn.restype = ctypes.c_int
    return lib


def ball_query(centers: torch.Tensor, points: torch.Tensor, radius: float,
               n_neighbors: int) -> torch.Tensor:
    """First ``n_neighbors`` points within ``radius`` of each center, in
    index order: (S, K) int32. Slots past the last hit repeat the first
    hit; a center with no hit gets all zeros (the reference CUDA
    kernel's fill, JAX ``_first_k_hits``).

    Memory: besides the (S, N) float32 distances it builds one (S, N)
    int32 candidate matrix (the column index of a hit, N elsewhere) and
    takes its K smallest; at VoteNet's first level (2048 x 40000) that
    is 328 MB, on top of the 82 MB boolean mask.
    """
    d2 = square_distance(centers, points)
    n = d2.shape[1]
    iota = torch.arange(n, dtype=torch.int32, device=d2.device)
    cand = torch.where(d2 < radius * radius, iota,
                       torch.full_like(iota, n))
    k = min(n_neighbors, n)
    take = torch.topk(cand, k, dim=1, largest=False, sorted=True).values
    if k < n_neighbors:  # fewer points than slots: pad with misses
        take = torch.cat([take, torch.full(
            (take.shape[0], n_neighbors - k), n, dtype=torch.int32,
            device=d2.device)], dim=1)
    first = take[:, :1]
    fallback = torch.where(first < n, first, torch.zeros_like(first))
    return torch.where(take < n, take, fallback)


def gather_points(features: torch.Tensor,
                  indices: torch.Tensor) -> torch.Tensor:
    """Gather along the first axis: (N, ...) by (S,) -> (S, ...)."""
    return features[indices.long()]


def group_points(points, features, centers_idx, group_idx,
                 use_xyz: bool = True, new_xyz=None) -> torch.Tensor:
    """Query-and-group: (S, K, 3[+C]) local-offset xyz (+ features).

    ``centers_idx`` (S,) picks the centers from ``points``, or is None
    with ``new_xyz`` (S, 3) giving them; ``group_idx`` is (S, K).
    """
    gi = group_idx.long()
    centers = new_xyz if centers_idx is None else points[centers_idx.long()]
    grouped_xyz = points[gi] - centers[:, None, :]
    if features is None:
        return grouped_xyz
    grouped_feat = features[gi]
    if use_xyz:
        return torch.cat([grouped_xyz, grouped_feat], dim=-1)
    return grouped_feat


def three_nn(unknown: torch.Tensor,
             known: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """3 nearest known points of each unknown point: ((U, 3) distances,
    (U, 3) int32 indices). Ties go to the lower index, as ``lax.top_k``
    breaks them: a stable ascending sort (``torch.topk`` promises no
    order among ties)."""
    d2 = square_distance(unknown, known)
    vals, idx = torch.sort(d2, dim=1, stable=True)
    return (torch.sqrt(torch.clamp(vals[:, :3], min=0.0)),
            idx[:, :3].to(torch.int32))


def three_interpolate(features: torch.Tensor, indices: torch.Tensor,
                      weights: torch.Tensor) -> torch.Tensor:
    """Weighted sum of 3 neighbour features: (K, C), (U, 3), (U, 3) ->
    (U, C)."""
    gathered = features[indices.long()]  # (U, 3, C)
    return torch.sum(gathered * weights[..., None], dim=1)


def interpolation_weights(dist: torch.Tensor, eps: float = 1e-8):
    """Inverse-distance weights of the PointNet++ FP modules."""
    recip = 1.0 / torch.clamp(dist * dist, min=eps)
    return recip / torch.sum(recip, dim=-1, keepdim=True)
