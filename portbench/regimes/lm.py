"""Regime B: DFedPGP rounds of a language model, every client on one card
(`launch.steps.build_train_algo` with the AlgoSpec that
`launch.train.make_cli_spec` makes of the cell's flags, `init_flat`, then
`round_fn_flat`, or `induced_subgraph` and `round_fn_sampled`: the calls
`launch.train.Trainer` makes each round; the Trainer draws its own
weights and batches, so the benchmark builds through the same calls with
its own)."""
from __future__ import annotations

import functools

import torch

from portbench import inputs
from portbench.metrics import flops
from portbench.reference import qwen2 as ref_qwen2
from portbench.regimes.common import DFedPGPCell

# configuration file key -> the program's ModelConfig field
FIELDS = {"num_hidden_layers": "n_layers", "hidden_size": "d_model",
          "num_attention_heads": "n_heads",
          "num_key_value_heads": "n_kv_heads",
          "intermediate_size": "d_ff", "vocab_size": "vocab",
          "rope_theta": "rope_theta", "rms_norm_eps": "norm_eps",
          "qkv_bias": "qkv_bias", "param_dtype": "param_dtype",
          "compute_dtype": "compute_dtype", "remat": "remat"}


class Cell(DFedPGPCell):
    PERSONAL = frozenset({"lm_head", "final_norm"})

    def model_config(self):
        """The program's config of the arch with every size the file
        states (at full size the file's numbers are the arch's own)."""
        from repro_torch.configs import get_config
        base = get_config(self.config["arch"])
        return base.replace(**{f: self.config[k] for k, f in FIELDS.items()})

    def param_specs(self) -> list:
        c = self.config
        L, D, F = (c["num_hidden_layers"], c["hidden_size"],
                   c["intermediate_size"])
        V, H, Hkv = (c["vocab_size"], c["num_attention_heads"],
                     c["num_key_value_heads"])
        q, kv = H * (D // H), Hkv * (D // H)
        lec = inputs.lecun
        return [("embed", (V, D), ("normal", 0.02)),
                ("final_norm", (D,), "ones"),
                ("layers/attn/bk", (L, kv), "zeros"),
                ("layers/attn/bq", (L, q), "zeros"),
                ("layers/attn/bv", (L, kv), "zeros"),
                ("layers/attn/wk", (L, D, kv), lec(D)),
                ("layers/attn/wo", (L, q, D), lec(q)),
                ("layers/attn/wq", (L, D, q), lec(D)),
                ("layers/attn/wv", (L, D, kv), lec(D)),
                ("layers/ln1", (L, D), "ones"),
                ("layers/ln2", (L, D), "ones"),
                ("layers/mlp/wd", (L, F, D), lec(F)),
                ("layers/mlp/wg", (L, D, F), lec(D)),
                ("layers/mlp/wu", (L, D, F), lec(D)),
                ("lm_head", (D, V), lec(D))]

    def prepare(self) -> None:
        self.cfg = self.model_config()

    def build(self, tree: dict):
        from repro_torch.launch import mesh, steps, train
        t, h = self.traffic, self.hyper
        flags = ["--arch", self.config["arch"], "--clients", str(self.m),
                 "--batch", str(t["batch"]), "--seq", str(t["seq"]),
                 "--k_u", str(h.k_u), "--k_v", str(h.k_v),
                 "--neighbors", str(self.neighbors), "--resident",
                 "--sample", str(self.frac)]
        spec = train.make_cli_spec(train.build_parser().parse_args(flags),
                                   "matrix")
        layout = mesh.one_device_layout(self.m, int(t["batch"]))
        algo, _, _, flat_layout = steps.build_train_algo(
            self.cfg, None, layout, k_u=h.k_u, k_v=h.k_v, spec=spec, lr=h.lr)
        return algo, flat_layout

    def batches(self, r: int, active) -> dict:
        t, h = self.traffic, self.hyper
        rows = self.m if active is None else len(active)
        b = inputs.token_batches(self.seed, r, rows, h.k_v + h.k_u,
                                 int(t["batch"]), int(t["seq"]),
                                 self.config["vocab_size"], self.device)
        return inputs.split_steps(b, h.k_v)

    def reference_loss(self, control: bool):
        """The reference in f32 (TF32 off around it); the control in the
        configuration's compute dtype with every weight product in fp8."""
        dtype = getattr(torch, self.config["compute_dtype"]) if control \
            else torch.float32
        return functools.partial(ref_qwen2.loss, cfg=self.config,
                                 dtype=dtype, fp8=control)

    # -- the work a round does ----------------------------------------------
    def flops_per_round(self) -> float:
        c, h, t = self.config, self.hyper, self.traffic
        return flops.lm_round(self.n_active(), h.k_v, h.k_u, int(t["batch"]),
                              int(t["seq"]), c["num_hidden_layers"],
                              c["hidden_size"], c["num_attention_heads"],
                              c["num_key_value_heads"],
                              c["intermediate_size"], c["vocab_size"])

    def precision(self) -> str:
        return "bf16" if self.config["compute_dtype"] == "bfloat16" else "f32"
