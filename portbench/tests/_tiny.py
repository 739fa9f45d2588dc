"""Tiny versions of the benchmark's cells for CPU tests: the cell's own
files with the sizes cut, f32 throughout."""
from portbench import catalog

LIMITS = {"loss_gap": 1e-5, "grad_gap": 1e-5, "change_gap": 1e-5,
          "dormant_moved": 0}


def limits(workload: str) -> dict:
    """LIMITS for the numbers the cell's limits file compares."""
    return {k: LIMITS[k] for k in catalog.read("limits", workload)}


def config(name: str) -> dict:
    cfg = catalog.read("configs", name)
    if cfg["regime"] == "sim":
        return dict(cfg, image_size=8)
    return dict(cfg, num_hidden_layers=2, hidden_size=64,
                num_attention_heads=4, num_key_value_heads=2,
                intermediate_size=128, vocab_size=256,
                compute_dtype="float32", remat=False)


def traffic(name: str) -> dict:
    t = catalog.read("traffic", name)
    if "n_train" in t:
        return dict(t, clients=6, n_train=24, neighbors=2, batch=4, k_u=2,
                    participation=min(t["participation"] * 2, 1.0))
    return dict(t, seq=16)


# every traffic mix of traffic/ and its configuration, the cells of
# BENCHMARK.json and those whose files wait for a later one
CONFIGS = {"cnn32-full": "cnn-cifar32", "cnn32-sampled25": "cnn-cifar32",
           "qwen2-0.5b-full": "qwen2-0.5b",
           "qwen2-0.5b-sampled50": "qwen2-0.5b"}


def cell(workload: str):
    """-> (catalog.Cell, tiny config, tiny traffic) of a mix of
    traffic/ (traffic and limits named as the cell)."""
    bench = catalog.load_benchmark()
    c = catalog.Cell(workload, CONFIGS[workload], workload, 1,
                     tuple(m for m in bench["end_to_end"]
                           if workload in m.get("workloads", [workload])),
                     ())
    return c, config(c.config), traffic(c.traffic)
