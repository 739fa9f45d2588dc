"""The port's twins of the four example scripts (`examples/*_torch.py`),
loaded by path and run on the CPU (`--device cpu`) at their smallest
sizes: quickstart at its own, paper_reproduction for 2 rounds of 8
clients, datacenter_gossip for 2 rounds, serve_decode for 4 tokens.  Each
prints its result; the serve twin's greedy tokens equal the port's
full-model dense decode of each request's user (client 0's trunk, exact
on the consensused buffer, with that user's final_norm and lm_head;
user 0's is client 0's whole model)."""
import importlib.util
import json
import math
import re
from pathlib import Path

import pytest
import torch

from repro_torch import configs
from repro_torch.models import dense
from repro_torch.serve import decode, from_train_state

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _twin(name):
    spec = importlib.util.spec_from_file_location(f"{name}_torch_twin",
                                                  EXAMPLES / f"{name}_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_twins_import_neither_jax_nor_the_reference():
    for name in ("quickstart", "paper_reproduction", "datacenter_gossip",
                 "serve_decode"):
        text = (EXAMPLES / f"{name}_torch.py").read_text()
        imports = [ln for ln in text.splitlines()
                   if re.match(r"\s*(import|from)\s", ln)]
        assert not [ln for ln in imports
                    if re.search(r"\b(jax|repro)\b(?!_torch)", ln)], name


def test_quickstart_twin(capsys):
    results = _twin("quickstart").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "16 clients, Dirichlet(0.3), 20 rounds" in out
    assert "personalized test accuracy:" in out
    assert set(results) == {"local", "fedavg", "dfedpgp"}
    assert all(0.0 <= acc <= 1.0 for acc in results.values())
    for algo, acc in results.items():
        assert f"{algo:10s} {acc:.4f}" in out


def test_paper_reproduction_twin(tmp_path, capsys):
    path = tmp_path / "out" / "paper.json"
    hist = _twin("paper_reproduction").main(
        ["--rounds", "2", "--clients", "8", "--algos", "dfedpgp,fedrep",
         "--out", str(path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"histories -> {path}" in out
    saved = json.loads(path.read_text())
    assert set(saved) == set(hist) == {"dfedpgp", "fedrep"}
    for algo, h in saved.items():
        assert 0.0 <= h["final_acc"] <= 1.0
        assert all(math.isfinite(x) for x in h["loss"])
        assert f"{algo:10s} {h['final_acc']:.4f}" in out


def test_paper_reproduction_twin_refuses_an_unknown_algo(tmp_path):
    with pytest.raises(SystemExit):
        _twin("paper_reproduction").main(
            ["--rounds", "1", "--algos", "nope", "--out",
             str(tmp_path / "p.json"), "--device", "cpu"])
    assert not (tmp_path / "p.json").exists()


def test_datacenter_gossip_twin(capsys):
    state = _twin("datacenter_gossip").main(["--rounds", "2", "--device",
                                             "cpu"])
    out = capsys.readouterr().out
    assert "qwen2-0.5b family=dense clients=4" in out
    losses = [float(x) for x in re.findall(r"dfedpgp loss=(\S+)", out)]
    assert len(losses) == 2 and all(math.isfinite(x) for x in losses)
    assert torch.isfinite(state.mu).all()


def test_serve_decode_twin_tokens_are_each_users_full_model(capsys):
    arch, m, B, T = "qwen2-0.5b", 4, 8, 4
    assert _twin("serve_decode").main(
        ["--arch", arch, "--tokens", str(T), "--batch", str(B),
         "--clients", str(m), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    got = {int(r): (int(u), json.loads(seq)) for r, u, seq in re.findall(
        r"req (\d+) \(user (\d+)\) (\[[^\]]*\])", out)}
    assert sorted(got) == [0, 1, 2, 3]
    # the twin's fleet, rebuilt from the same seed
    cfg = configs.get_reduced(arch)
    state, layout = decode.build_fleet(cfg, m, device="cpu")
    sstate = from_train_state(state, layout=layout, consensus=0)
    with torch.no_grad():
        for r, (user, seq) in got.items():
            assert user == r % m
            full = sstate.user_model(user)
            cache = dense.init_cache(cfg, 1, decode.CACHE_LEN, device="cpu")
            tok, want = torch.zeros((1, 1), dtype=torch.int64), []
            for t in range(T):
                logits, cache = dense.decode_step(full, cache, tok, t, cfg)
                tok = torch.argmax(logits[:, -1], dim=-1, keepdim=True)
                want.append(int(tok))
            assert seq == want, (r, user)


def test_twins_run_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="cpu"):
        _twin("serve_decode").main(["--tokens", "1"])
    with pytest.raises(RuntimeError, match="cpu"):
        _twin("quickstart").main([])
