"""The round counter's host value (`core.dfedpgp.host_round`) and the
`Codec` protocol.

A randomized codec seeds its round's draws from (codec.seed, round): the
round is read on the host beside the state's device counter, so a codec
round records no `aten._local_scalar_dense` (the analyzer's host-sync
detector over a resident codec round at m 13, rounds 1-2), where reading
`int(rnd)` off the counter did record one a round.  The draws are the
same bit for bit (the codec tests of tests/test_torch_compress.py hold
them against the reference)."""
import dataclasses

import pytest
import torch

from repro_torch import compress, convert
from repro_torch.analysis import detectors, programs
from repro_torch.core import dfedpgp, topology


def _codec_program(kind: str) -> programs.ProgramInstance:
    """simA.resident with a lossy codec: the quad problem's resident
    rounds through `_codec_mix`."""
    dev = torch.device("cpu")
    algo, cu, cv = programs._quad_setup(dev)
    algo = dataclasses.replace(algo, codec=compress.make_codec(kind,
                                                               ratio=0.5))
    state0, layout = algo.init_flat({"body": cu, "head": cv}, device=dev)
    Ps = programs._tables(None, topology.TopologySchedule.random(
        programs.SIM_M, 3, seed=13), dev)
    b = programs._quad_batches(cu, cv, algo.k_v, algo.k_u)
    return programs.ProgramInstance(
        name=f"simA.resident.{kind}",
        fn=lambda s, P, bb: algo.round_fn_flat(s, P, bb, layout),
        round_args=tuple((P, b) for P in Ps),
        fresh_state=lambda: programs._copy_state(state0),
        donate=(0,), m=programs.SIM_M, device=dev)


@pytest.mark.parametrize("kind", ["randk", "qsgd", "topk"])
def test_codec_round_reads_no_device_value(kind):
    assert detectors.check_host_sync(_codec_program(kind)) == []


@pytest.mark.parametrize("kind", ["randk", "qsgd"])
def test_reading_the_device_counter_is_caught(kind, monkeypatch):
    # the old read, put back: the detector sees it in every round
    monkeypatch.setattr(dfedpgp, "host_round", lambda rnd: int(rnd))
    found = detectors.check_host_sync(_codec_program(kind))
    assert any("_local_scalar_dense" in v for v in found), found


def test_round_counters_carry_their_host_value():
    rnd = dfedpgp.round_counter(5, "cpu")
    assert dfedpgp.host_round(rnd) == 5
    nxt = dfedpgp._next_round(rnd)
    assert int(nxt) == 6 and dfedpgp.host_round(nxt) == 6
    # a counter made elsewhere is read once, then known
    other = torch.tensor(9, dtype=torch.int32)
    assert dfedpgp.host_round(other) == 9
    assert dfedpgp.host_round(dfedpgp._next_round(other)) == 10


def test_converted_state_registers_its_round():
    import numpy as np
    st = convert.flat_state_from_reference(
        flat=np.zeros((2, 3), np.float32), personal={"h": np.zeros((2, 1))},
        mu=np.ones(2), mom_u=np.zeros((2, 3), np.float32),
        mom_v={"h": np.zeros((2, 1))}, round=np.asarray(7, np.int32))
    assert dfedpgp._HOST_ROUNDS.get(st.round) == 7


@pytest.mark.parametrize("kind", ["identity", "topk", "randk", "qsgd"])
def test_codecs_satisfy_the_protocol(kind):
    codec = compress.make_codec(kind)
    assert isinstance(codec, compress.Codec)
    assert isinstance(codec.draws, bool) and isinstance(codec.exact, bool)


def test_protocol_refuses_a_non_codec():
    assert not isinstance(object(), compress.Codec)
