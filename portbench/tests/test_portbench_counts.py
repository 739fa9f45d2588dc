"""The yardstick's arithmetic against hand counts: FLOPs of a round, the
kernels' least bytes, the part lookup, and the profiler slice's reduction
of events (on made-up events: a CPU run has no device trace)."""
import types

import pytest

from portbench.metrics import flops, kernel_bytes, peaks, trace


@pytest.mark.parametrize("image,batch", [(32, 32), (8, 4)])
def test_cnn_round_flops_by_hand(image, batch):
    # conv1 3x3x3->16 at image^2, conv2 3x3x16->32 at (image/2)^2, dense
    # 32 (image/4)^2 -> 64, head 64 -> 10; 2 FLOPs a multiply-add
    f1 = 2 * batch * image * image * 27 * 16
    f2 = 2 * batch * (image // 2) ** 2 * 144 * 32
    fd = 2 * batch * 32 * (image // 4) ** 2 * 64
    fh = 2 * batch * 64 * 10
    fwd = f1 + f2 + fd + fh
    v_step = fwd + fh
    u_step = fwd + (f1 + f2 + fd) + (fh + fd + f2)
    want = 7 * (1 * v_step + 5 * u_step)
    assert flops.cnn_round(7, 1, 5, batch, image, 3, (16, 32), 64, 10) \
        == pytest.approx(want, rel=1e-12)


def test_cnn_round_at_cifar_shape():
    assert flops.cnn_round(100, 1, 5, 32, 32, 3, (16, 32), 64, 10) == \
        pytest.approx(165_409_587_200, rel=1e-12)


@pytest.mark.parametrize("seq,layers", [(256, 24), (16, 2)])
def test_lm_round_flops_by_hand(seq, layers):
    d, h, kv, ff, vocab, batch = 896, 14, 2, 4864, 151_936, 2
    hd = d // h
    weights = layers * (d * h * hd + 2 * d * kv * hd + h * hd * d
                        + 3 * d * ff) + d * vocab
    tokens = batch * seq
    u = 6 * weights * tokens + 12 * layers * d * seq * tokens
    v = 2 * weights * tokens + 4 * layers * d * seq * tokens \
        + 4 * d * vocab * tokens
    assert flops.lm_round(3, 1, 2, batch, seq, layers, d, h, kv, ff,
                          vocab) == pytest.approx(3 * (v + 2 * u), rel=1e-12)


@pytest.mark.parametrize("n,k,d,want", [
    (100, 11, 136_208, 100 * 136_208 * 4 * 2 + 100 * 11 * 8),
    (4, 3, 494_031_872, 4 * 494_031_872 * 4 * 2 + 4 * 3 * 8)])
def test_gather_bytes_by_hand(n, k, d, want):
    assert kernel_bytes.gather(n, k, n, d, 4) == want


@pytest.mark.parametrize("n,d,want", [
    (25, 136_208, 2 * 25 * 136_208 * 8 + 100),
    (2, 494_031_872, 2 * 2 * 494_031_872 * 8 + 8)])
def test_scatter_bytes_by_hand(n, d, want):
    assert kernel_bytes.scatter(n, d, 2, 4, 4) == want


def test_parts_by_name():
    assert peaks.part("NVIDIA H100 80GB HBM3") == "SXM"
    assert peaks.part("NVIDIA H100 PCIe") == "PCIe"
    assert peaks.part("NVIDIA H100 NVL") == "NVL"
    assert peaks.hbm("NVIDIA H100 80GB HBM3") == 3.35e12
    assert peaks.flops("NVIDIA H100 80GB HBM3", "bf16") == 989e12
    assert peaks.flops("NVIDIA H100 80GB HBM3", "tf32") == 495e12


def _ev(name, start, end, device):
    return types.SimpleNamespace(
        name=name, device_type=f"DeviceType.{device}",
        time_range=types.SimpleNamespace(start=start, end=end))


def test_slice_reduction_of_made_up_events():
    events = [
        _ev("portbench.slice", 0, 1000, "CPU"),
        _ev("portbench.plan", 0, 100, "CPU"),
        _ev("portbench.dispatch", 100, 900, "CPU"),
        _ev("portbench.sync", 900, 1000, "CPU"),
        _ev("portbench.dispatch", 150, 950, "CUDA"),     # an annotation
        _ev("aten::mm", 120, 300, "CPU"),
        _ev("void gossip_gather_panel_kernel<float, true, true>(int)",
            300, 400, "CUDA"),
        _ev("sm90_xmma_gemm", 350, 600, "CUDA"),
        _ev("void gossip_scatter_kernel<float>(int)", 800, 850, "CUDA"),
    ]
    s = trace.reduce(events, rounds=2)
    assert s.wall_s == pytest.approx(1e-3)
    assert s.busy_s == pytest.approx(350e-6)          # 300-600, 800-850
    assert s.port_s == {"gossip_gather": [pytest.approx(1e-4)],
                        "gossip_scatter": [pytest.approx(5e-5)]}
    assert s.library_s == pytest.approx(250e-6)
    gaps = dict((k, v) for k, v in s.idle_gaps)
    assert gaps["plan"] == pytest.approx(100e-6)
    assert gaps["dispatch: aten::mm"] == pytest.approx(200e-6)
    assert sum(gaps.values()) == pytest.approx(650e-6)
    assert all(not n.startswith("portbench.") for n, _ in s.device_ops)


def test_kernel_names_map_to_their_port_kernel():
    assert trace.port_kernel("void gossip_gather_kernel<float>(x)") == \
        "gossip_gather"
    assert trace.port_kernel("gossip_gather_panel_kernel") == "gossip_gather"
    assert trace.port_kernel("ampere_sgemm_128x64_nn") is None
    assert trace.merge([(5, 9), (0, 3), (2, 4), (8, 12)], 1, 10) == \
        [[1, 4], [5, 10]]
