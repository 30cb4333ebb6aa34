"""K3's launch plan (``ops/pointnet.fps_plan``): the cluster size and the
slice of the cloud each CTA holds, a pure function of (N, C) that the
wrapper computes on the host. The kernel itself runs only on the card
(``tests/test_torch_kernels_cuda.py``)."""

import pytest

from nerfdet_tpu_torch.ops import pointnet

SHAPES = [
    (40000, 3), (2048, 3), (1024, 3), (512, 3), (1024, 3),  # VoteNet
    (4096, 19),  # F-FPS
    (40001, 3), (8191, 3), (1, 3), (231000, 3), (5000, 32),
]


@pytest.mark.parametrize("n,c", SHAPES)
def test_fps_plan_covers_the_cloud(n, c):
    k, slice_, smem = pointnet.fps_plan(n, c)
    assert k in (1, 2, 4, 8, 16)
    # the slices cover N exactly: none is empty, none is missing
    assert k * slice_ >= n and (k - 1) * slice_ < n
    assert smem == pointnet.fps_smem_bytes(c, slice_) <= 232448
    # the smallest cluster whose slices fit one CTA's share
    if k > 1:
        half = -(-n // (k // 2))
        assert (half > pointnet.FPS_CTA_POINTS
                or pointnet.fps_smem_bytes(c, half) > 232448)


@pytest.mark.parametrize("n,c,k", [
    (40000, 3, 16), (2048, 3, 1), (1024, 3, 1), (512, 3, 1), (4096, 19, 2),
    (1, 3, 1),
])
def test_fps_plan_sizes_on_the_paths(n, c, k):
    assert pointnet.fps_plan(n, c)[0] == k


@pytest.mark.parametrize("n,c", [(240000, 3), (60000, 16), (4000, 1000)])
def test_fps_plan_refuses_a_cloud_above_a_16_cta_cluster(n, c):
    with pytest.raises(ValueError, match="16-CTA cluster"):
        pointnet.fps_plan(n, c)


@pytest.mark.parametrize("k", [1, 2, 4, 8, 16])
def test_fps_plan_gives_a_cta_2048_points(k):
    """The card tests reach every cluster size through these clouds."""
    assert pointnet.fps_plan(2048 * k, 3)[:2] == (k, 2048)
    if k < 16:
        assert pointnet.fps_plan(2048 * k + 1, 3)[0] == 2 * k
