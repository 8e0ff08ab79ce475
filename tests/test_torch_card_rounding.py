"""Where the card's frames part from the CPU's (ROADMAP queue 3, item u,
the card's side): the ORB extractor's stages on both devices, compared
stage by stage by ``scripts/trace_torch_determinism.py::frame_diff``.

The card's level images part from the CPU's in the last bits at every
resized level (``resize_bilinear`` is two matmuls, summed in another
order by cuBLAS than by the CPU's BLAS); the keypoints are the same;
the keypoint stage gives the other device's angles to atan2's last bit
and its descriptors exactly, once both are fed the same level images.
So every angle that parts by more (1.4e-4 rad on the exploration's
second frame, 5.1e-4 on the mono orbit's third) parts through the
level images.  Needs the card: ``python3 -m pytest -m cuda
tests/test_torch_card_rounding.py``.
"""

import pytest

LEVEL_ATOL = 1e-4    # a few float32 ulps of a 0..255 pixel
ANGLE_ATOL = 1e-6    # atan2's last bits, in radians


@pytest.mark.cuda
@pytest.mark.parametrize("frame", [0, 2])
def test_card_frames_part_in_the_level_images(frame):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    import chip_smoke
    from active_orb_slam2_tpu_torch.config import SlamConfig
    from scripts.trace_torch_determinism import frame_diff
    d = frame_diff(chip_smoke._render_mono_frame(frame),
                   SlamConfig(sensor="mono"), torch.device("cuda", 0))
    print(d)
    assert d["levels"][0] == (0, 0.0)
    assert all(err <= LEVEL_ATOL for _, err in d["levels"])
    assert d["keypoints"] == 0
    for same in ("same_input_kernel", "same_input_plain",
                 "card_input_plain_cpu"):
        assert d[same]["angle"][1] <= ANGLE_ATOL, (same, d[same])
        assert d[same]["desc"] == 0, (same, d[same])
