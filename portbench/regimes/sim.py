"""Regime A: the simulator's DFedPGP rounds of the CNN, every client on
one card (`fl.simulator.build_algorithm("dfedpgp", ...)`, `init_flat`,
then `round_fn_flat`, or `induced_subgraph` and `round_fn_sampled`: the
calls `fl.simulator.run_experiment` makes each round)."""
from __future__ import annotations

import functools

import torch

from portbench import inputs
from portbench.metrics import flops
from portbench.reference import cnn as ref_cnn
from portbench.regimes.common import DFedPGPCell


class Cell(DFedPGPCell):
    PERSONAL = frozenset({"classifier/w", "classifier/b"})

    def param_specs(self) -> list:
        c = self.config
        c1, c2 = c["widths"]
        ch, fd = c["channels"], c["d_feature"]
        feat = c2 * (c["image_size"] // 4) ** 2
        return [("features/conv1", (3, 3, ch, c1), inputs.lecun(9 * ch)),
                ("features/gn1", (c1,), "ones"),
                ("features/gb1", (c1,), "zeros"),
                ("features/conv2", (3, 3, c1, c2), inputs.lecun(9 * c1)),
                ("features/gn2", (c2,), "ones"),
                ("features/gb2", (c2,), "zeros"),
                ("features/dense", (feat, fd), inputs.lecun(feat)),
                ("classifier/w", (fd, c["n_classes"]), inputs.lecun(fd)),
                ("classifier/b", (c["n_classes"],), "zeros")]

    def prepare(self) -> None:
        c, t = self.config, self.traffic
        self.x, self.y = inputs.image_data(
            self.seed, self.m, int(t["n_train"]), c["image_size"],
            c["channels"], c["n_classes"], float(t["alpha"]),
            float(t["noise"]), self.device)

    def build(self, tree: dict):
        from repro_torch.core import partition
        from repro_torch.fl import simulator
        from repro_torch.models import cnn
        c, t, h = self.config, self.traffic, self.hyper
        model_cfg = cnn.CNNConfig(
            image_size=c["image_size"], channels=c["channels"],
            n_classes=c["n_classes"], widths=tuple(c["widths"]),
            d_feature=c["d_feature"], gn_groups=c["gn_groups"])
        sim = simulator.SimConfig(
            m=self.m, n_neighbors=self.neighbors, batch=int(t["batch"]),
            k_local=h.k_u, k_personal=h.k_v, lr=h.lr, momentum=h.momentum,
            weight_decay=h.wd, lr_decay=h.decay, n_classes=c["n_classes"],
            image_size=c["image_size"], gossip=t["gossip"])

        def loss_fn(p, batch):
            return cnn.loss_fn(p, batch, model_cfg)

        mask = partition.build_mask(tree, partition.classifier_personal)
        return simulator.build_algorithm("dfedpgp", loss_fn, mask, sim), None

    def batches(self, r: int, active) -> dict:
        t = self.traffic
        rows = torch.arange(self.m, device=self.device) if active is None \
            else torch.as_tensor(active, dtype=torch.long, device=self.device)
        idx = inputs.minibatch_rows(self.seed, r, rows.shape[0],
                                    int(t["n_train"]),
                                    self.hyper.k_v + self.hyper.k_u,
                                    int(t["batch"]), self.device)
        cl = rows[:, None, None]
        return inputs.split_steps({"x": self.x[cl, idx], "y": self.y[cl, idx]},
                                  self.hyper.k_v)

    def reference_loss(self, control: bool):
        dtype = torch.bfloat16 if control else torch.float32
        return functools.partial(ref_cnn.loss, cfg=self.config, dtype=dtype)

    # -- the work a round does ----------------------------------------------
    def flops_per_round(self) -> float:
        c, h = self.config, self.hyper
        return flops.cnn_round(self.n_active(), h.k_v, h.k_u,
                               int(self.traffic["batch"]), c["image_size"],
                               c["channels"], tuple(c["widths"]),
                               c["d_feature"], c["n_classes"])

    def precision(self) -> str:
        """The convolutions' precision: TF32 where cuDNN may use it (the
        program leaves PyTorch's default, on)."""
        return "tf32" if torch.backends.cudnn.allow_tf32 else "f32"
