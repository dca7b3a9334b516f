"""Card-only tests of the hand-written Hopper kernel: every specialisation
({no props, props} × {apply, apply+compact}) against its plain PyTorch
version on the same CUDA inputs, and the store and engine on the card
against the same on the CPU. Tolerance: exact (int32).

Run on a machine with a card: ``python -m pytest -m cuda
tests/test_torch_cuda.py``. Without a card every test skips (the decision
is taken inside the fixture, so every worker collects the same tests)."""

import numpy as np
import pytest
import torch

from fluidframework_tpu_torch.ops import merge_tree as mt
from fluidframework_tpu_torch.ops import string_kernel as sk
from fluidframework_tpu_torch.testing.synthetic import (
    conflict_storm, edge_storm, typing_storm,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _clone(st):
    return mt.StringState(**{k: v.clone() for k, v in st.fields().items()})


@pytest.mark.parametrize("props", [False, True])
@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("S,corpus", [(128, "storm"), (384, "storm"),
                                      (256, "edge")])
def test_kernel_matches_plain(cuda, props, compact, S, corpus):
    D, O = 64, 32
    gen = edge_storm if corpus == "edge" else \
        conflict_storm if props else typing_storm
    st = mt.StringState.create(D, S, 4, device=cuda)
    ref = _clone(st)
    seq = 1
    for b in range(3):
        planes, seq = gen(D, O, seed=b, start_seq=seq)
        ops = [torch.as_tensor(planes[k]).to(cuda) for k in mt.OP_FIELDS]
        ms = torch.full((D,), max(seq - D * 16, 0), dtype=torch.int32,
                        device=cuda) if compact else None
        before = sk.launches
        sk.apply_string_batch_fused(st, *ops, min_seq=ms, with_props=props)
        assert sk.launches == before + 1
        ref = mt.apply_string_batch(ref, *ops, with_props=props)
        if compact:
            ref = mt.compact_string_state(ref, ms, props)
        torch.cuda.synchronize()
        keys = mt.PLANES + (("prop_val",) if props else ())
        if not compact:   # full planes, slots past count included
            for k in keys + ("count", "overflow"):
                assert torch.equal(getattr(st, k), getattr(ref, k)), (b, k)
            continue
        assert torch.equal(st.count, ref.count)
        cnt = st.count.cpu().numpy()
        for k in keys:
            a, c = getattr(st, k).cpu().numpy(), getattr(ref, k).cpu().numpy()
            for d in range(D):
                assert np.array_equal(a[d, :cnt[d]], c[d, :cnt[d]]), (b, k, d)
        assert torch.equal(mt.string_state_digest(st),
                           mt.string_state_digest(ref))


def test_engine_on_card_matches_cpu(cuda):
    from fluidframework_tpu_torch.server.ingest_pipeline import (
        PipelinedIngestExecutor,
    )
    from fluidframework_tpu_torch.server.serving import StringServingEngine
    R, O = 16, 16
    engines = [StringServingEngine(n_docs=R, capacity=256,
                                   batch_window=10 ** 9, compact_every=2,
                                   sequencer="native", device=dev)
               for dev in (cuda, "cpu")]
    docs = [f"d{i}" for i in range(R)]
    for eng in engines:
        for d in docs:
            eng.connect(d, 1)
        rows = np.array([eng.doc_row(d) for d in docs], np.int32)
        with PipelinedIngestExecutor(eng, depth=3) as ex:
            for b in range(4):
                planes, _ = typing_storm(R, O, seed=b)
                cs = np.broadcast_to(np.arange(b * O + 1, (b + 1) * O + 1,
                                               dtype=np.int32), (R, O))
                ex.submit(rows, np.ones((R, O), np.int32), cs, cs,
                          planes["kind"], planes["a0"], planes["a1"],
                          text="abcd")
            ex.drain()
    for d in docs:
        assert engines[0].read_text(d) == engines[1].read_text(d), d
    assert np.array_equal(engines[0].store.digests(),
                          engines[1].store.digests())
