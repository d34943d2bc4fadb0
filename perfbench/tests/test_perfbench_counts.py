"""The FLOP and byte counts behind the MFU and roofline metrics, against
counts by hand."""
import pytest

from perfbench.harness import counts

BILSTM = {"FFT_SIZE": 256, "EMBED_SIZE": 20, "ENCODER_TYPE": "bilstm-orig",
          "COMPUTE_DTYPE": "float32"}
PAPER = {"BILSTM_HIDDEN": 300, "BILSTM_LAYERS": 4}
DPRNN = {"FFT_SIZE": 256, "EMBED_SIZE": 20, "ENCODER_TYPE": "dprnn-v1",
         "DPRNN_DIM": 128, "DPRNN_HIDDEN": 128, "DPRNN_CHUNK": 64,
         "DPRNN_BLOCKS": 6, "COMPUTE_DTYPE": "float32"}


def test_kernel_b_bound_at_a_ten_second_request():
    # 2 directions x 1251 steps x (300 x 1200) multiply-adds = 1.80 GFLOP
    # over 67 TFLOP/s: PERF.md's Bound column, 0.0269 ms by ops
    s = counts.scan_bound_s(1251, 1, 300, 2, "lean")
    assert s * 1e3 == pytest.approx(2 * 2 * 1251 * 300 * 1200 / 67e9)
    assert round(s * 1e3, 4) == 0.0269


def test_kernels_2_and_3_bounds_at_the_training_shape():
    # 5.90 GFLOP each at (T=128, B=32): 0.0880 ms; their bytes (98 MB for
    # kernel 2) take 0.029 ms, so ops bound both
    for kind in ("save", "bwd"):
        assert round(counts.scan_bound_s(128, 32, 300, 2, kind) * 1e3,
                     4) == 0.0880
    # dprnn-v1's inter-chunk scan (T=3, B=2048, H=128): 0.0240 ms
    assert round(counts.scan_bound_s(3, 2048, 128, 2, "lean") * 1e3,
                 4) == 0.0240


def test_bilstm_step_flops():
    # per frame and row: layer 0 2 x 2 x (129 + 300) x 1200, layers 1-3
    # 2 x 2 x (600 + 300) x 1200 each, the head 2 x 600 x 2580:
    # 18.11 MFLOP; x 4096 frame-rows x 3 = 222.6 GFLOP a step
    per = 4 * 429 * 1200 + 3 * 4 * 900 * 1200 + 2 * 600 * 2580
    assert per == 18_115_200
    got = 3 * counts.forward_flops(BILSTM, PAPER, 32, 128)
    assert got == pytest.approx(3 * per * 4096)
    assert round(got / 1e9, 1) == 222.6


def test_dprnn_step_flops():
    # 3 chunks of 64 at hop 32 over 128 frames; per block and chunk-frame
    # two BiLSTMs of 2 x 2 x 256 x 512 and two 256 -> 128 linears:
    # 1.18 MFLOP x 6144 chunk-frames x 6 blocks, plus the bottleneck and
    # the head over 4096 frames: 46.33 GFLOP forward, 139.0 a step
    assert counts.dprnn_chunks(DPRNN, 128) == (64, 3)
    block = 2 * (2 * 2 * 256 * 512 + 2 * 256 * 128)
    fwd = 6 * block * 32 * 3 * 64 + 4096 * 2 * (129 * 128 + 128 * 2580)
    got = 3 * counts.forward_flops(DPRNN, {}, 32, 128)
    assert got == pytest.approx(3 * fwd)
    assert round(got / 1e9, 1) == 139.0


def test_a_step_of_scans_is_each_layers_forward_and_backward():
    assert counts.train_scan_bound_s(BILSTM, PAPER, 32, 128) == \
        pytest.approx(8 * counts.scan_bound_s(128, 32, 300, 2, "save"))
    assert len(counts.scans(DPRNN, {}, 32, 128)) == 12


def test_frames_of_a_request():
    # scipy's boundary: L + 256 padded to whole hops of 64, then frames
    assert counts.frames_of(80000, 256, 64) == 1251
    assert counts.frames_of(12000, 256, 64) == 189
