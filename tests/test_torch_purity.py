"""The PyTorch port stands alone: no module of ``fluidframework_tpu_torch``
and nothing in ``chip_smoke.py`` imports ``jax`` or the JAX package, and
the entry points refuse to run without a card unless ``device="cpu"`` is
given.

The scan reads the sources (AST), not ``sys.modules``: the interpreter may
already hold ``jax`` for reasons unrelated to the port."""

import ast
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
SOURCES = sorted(str(p.relative_to(ROOT)) for p in
                 (ROOT / "fluidframework_tpu_torch").rglob("*.py")) + \
    ["chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "fluidframework_tpu")


@pytest.mark.parametrize("path", SOURCES)
def test_no_jax_imports(path):
    tree = ast.parse((ROOT / path).read_text(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


def test_entry_points_need_a_card_unless_cpu_is_asked():
    from fluidframework_tpu_torch.ops.string_store import TensorStringStore
    from fluidframework_tpu_torch.ops.tree_store import TensorTreeStore
    from fluidframework_tpu_torch.server.serving import (
        StringServingEngine, TreeServingEngine,
    )
    if torch.cuda.is_available():
        assert TensorStringStore(8, 128).state.seq.device.type == "cuda"
        assert TensorTreeStore(8, 128).state.node_id.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            TensorStringStore(8, 128)
        with pytest.raises(RuntimeError, match="CUDA"):
            StringServingEngine(n_docs=8, capacity=128)
        with pytest.raises(RuntimeError, match="CUDA"):
            TensorTreeStore(8, 128)
        with pytest.raises(RuntimeError, match="CUDA"):
            TreeServingEngine(n_docs=8, capacity=128)
    assert TensorStringStore(8, 128, device="cpu").state.seq.is_cpu
    assert TensorTreeStore(8, 128, device="cpu").state.node_id.is_cpu
    assert TreeServingEngine(n_docs=8, capacity=128,
                             device="cpu").store.state.node_id.is_cpu


def test_serving_service_needs_a_card_unless_cpu_is_asked():
    """The in-process service keeps its string replica on the card by
    default; ``device="cpu"`` runs the plain version."""
    from fluidframework_tpu_torch.server.serving_service import (
        ServingLocalService,
    )
    if torch.cuda.is_available():
        svc = ServingLocalService(n_docs=8, capacity=128)
        assert svc.store.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            ServingLocalService(n_docs=8, capacity=128)
    svc = ServingLocalService(n_docs=8, capacity=128, device="cpu")
    assert svc.store.state.seq.is_cpu
    conn = svc.connect("d")
    conn.submit({"address": "default", "contents": {
        "address": "text", "contents": {
            "mt": "insert", "pos": 0, "kind": 0, "text": "x",
            "props": None, "clientSeq": 1}}})
    assert svc.read_text("d", "text") == "x"


def test_read_plane_entry_points_need_a_card_unless_cpu_is_asked():
    """The catch-up diff, its apply, the log follower and the read
    replica build their stores and engines on the card by default."""
    from fluidframework_tpu_torch.parallel.replicated import OplogFollower
    from fluidframework_tpu_torch.server.read_plane import (
        ReadReplica, apply_generation_diff, build_generation_diff,
    )
    from fluidframework_tpu_torch.server.serving import StringServingEngine
    leader = StringServingEngine(n_docs=2, capacity=64, device="cpu")
    leader.connect("a", 1)
    s0 = leader.summarize()
    leader.submit("a", 1, 1, 0, {"mt": "insert", "kind": 0, "pos": 0,
                                 "text": "x"})
    s1 = leader.summarize()
    diff = build_generation_diff("string", s0, s1, device="cpu")
    entries = [lambda: build_generation_diff("string", s0, s1),
               lambda: apply_generation_diff("string", diff, s0, leader.log),
               lambda: OplogFollower(leader, summary=s1),
               lambda: ReadReplica(leader, summary=s1)]
    for make in entries:
        if torch.cuda.is_available():
            make()
        else:
            with pytest.raises(RuntimeError, match="CUDA"):
                make()
    assert apply_generation_diff("string", diff, s0, leader.log,
                                 device="cpu").read_text("a") == "x"
    assert ReadReplica(leader, summary=s1, device="cpu").poll() == 0


def test_kernel_wrapper_checks_its_inputs():
    """Shape and dtype are refused before any launch (on either device)."""
    from fluidframework_tpu_torch.ops.merge_tree import StringState
    from fluidframework_tpu_torch.ops.string_kernel import (
        apply_string_batch_fused,
    )
    st = StringState.create(4, 128, device="cpu")
    ops = [torch.zeros((4, 8), dtype=torch.int32) for _ in range(7)]
    with pytest.raises(ValueError, match="shape"):
        apply_string_batch_fused(st, *ops[:6], torch.zeros((3, 8),
                                                           dtype=torch.int32))
    with pytest.raises(TypeError, match="int32"):
        apply_string_batch_fused(st, *ops[:6], ops[6].long())


@pytest.mark.parametrize("entry", ["map_store", "map_engine", "cell_store",
                                   "axis_store", "matrix_engine"])
def test_map_and_matrix_entry_points_need_a_card(entry):
    from fluidframework_tpu_torch.ops.axis_kernel import TensorAxisStore
    from fluidframework_tpu_torch.ops.map_kernel import TensorMapStore
    from fluidframework_tpu_torch.ops.matrix_kernel import TensorMatrixStore
    from fluidframework_tpu_torch.server.serving import (
        MapServingEngine, MatrixServingEngine,
    )
    make = {"map_store": lambda **kw: TensorMapStore(8, **kw),
            "map_engine": lambda **kw: MapServingEngine(n_docs=8, **kw),
            "cell_store": lambda **kw: TensorMatrixStore(64, **kw),
            "axis_store": lambda **kw: TensorAxisStore(8, 64, **kw),
            "matrix_engine": lambda **kw: MatrixServingEngine(
                n_docs=8, cell_capacity=64, axis_capacity=64, **kw)}[entry]
    if torch.cuda.is_available():
        make()
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    make(device="cpu")


def test_kernel_wrappers_refuse_cpu_tensors():
    """The bindings launch on CUDA tensors only: a CPU tensor never
    reaches them (the entry points run the plain version for it)."""
    from fluidframework_tpu_torch.ops import axis_apply, cell_merge, map_apply
    from fluidframework_tpu_torch.ops.map_kernel import MapState
    from fluidframework_tpu_torch.ops.matrix_kernel import MatrixCellState
    from fluidframework_tpu_torch.ops.merge_tree import StringState
    ops = [torch.zeros((4, 8), dtype=torch.int32) for _ in range(4)]
    with pytest.raises(ValueError, match="CUDA"):
        map_apply.launch_dense(MapState.create(4, 8, "cpu"), *ops)
    with pytest.raises(ValueError, match="CUDA"):
        cell_merge.launch(MatrixCellState.create(16, "cpu"),
                          *ops[0][0:3], L=None, fww=False)
    axes = StringState.create(4, 64, n_props=1, device="cpu")
    out = [torch.zeros((4, 8), dtype=torch.int32) for _ in range(2)]
    with pytest.raises(ValueError, match="CUDA"):
        axis_apply.launch_apply(axes, ops + ops[:3], *out)
    with pytest.raises(ValueError, match="CUDA"):
        axis_apply.launch_resolve(axes, *ops, *out)


def test_tree_kernel_wrappers_check_their_inputs():
    """K5's record planes and K6's wire lanes are refused by shape and
    dtype before any launch (on either device)."""
    from fluidframework_tpu_torch.ops import tree_kernel as tk
    st = tk.TreeState.create(4, 32, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        tk.apply_tree_planes_fused(st, torch.zeros((9, 3, 8),
                                                   dtype=torch.int32))
    with pytest.raises(TypeError, match="int32"):
        tk.apply_tree_planes_fused(st, torch.zeros((9, 4, 8),
                                                   dtype=torch.int64))
    u8, u16 = torch.uint8, torch.uint16
    m = torch.zeros(8, dtype=torch.int32)
    wire = [torch.zeros((5, 3), dtype=u8), torch.zeros((5, 3), dtype=u16),
            torch.zeros(5, dtype=u16), torch.zeros(5, dtype=u16),
            torch.zeros(5, dtype=u8)]
    tk.expand_tree_wire_fused(*wire, m, m, m, m, n_docs=4, o=8)
    bad_ids = list(wire)
    bad_ids[1] = wire[1].to(torch.int32)
    with pytest.raises(TypeError, match="ids"):
        tk.expand_tree_wire_fused(*bad_ids, m, m, m, m, n_docs=4, o=8)
    bad_pos = list(wire)
    bad_pos[4] = torch.zeros(4, dtype=u8)
    with pytest.raises(ValueError, match="shape"):
        tk.apply_tree_wire_fused(st, *bad_pos, torch.zeros(
            4, dtype=torch.int32), m, m, m, m, o=8)


#: every ctypes entry point that launches a hand kernel, by wrapper module
LAUNCHES = {
    "string_kernel.py": {"string_apply_launch"},
    "map_apply.py": {"map_apply_dense", "map_apply_packed"},
    "cell_merge.py": {"cell_merge_launch"},
    "axis_apply.py": {"axis_apply_launch", "axis_resolve_launch"},
    "tree_apply.py": {"tree_apply_launch", "tree_expand_launch"},
    "megadoc_apply.py": {"megadoc_apply_launch"},
}


def _under_device_guard(parents, node) -> bool:
    """Is ``node`` inside a ``with torch.cuda.device(...)`` block?"""
    while node in parents:
        node = parents[node]
        if isinstance(node, ast.With) and any(
                ast.unparse(item.context_expr.func) == "torch.cuda.device"
                for item in node.items
                if isinstance(item.context_expr, ast.Call)):
            return True
    return False


@pytest.mark.parametrize("module", sorted(LAUNCHES))
def test_every_launch_enters_the_tensors_device(module):
    """The libraries act on the CURRENT device (shared-memory opt-ins,
    SM counts, the launch itself): each wrapper makes its tensors' device
    current around the ctypes call, so a shard on another card launches
    there."""
    path = ROOT / "fluidframework_tpu_torch" / "ops" / module
    tree = ast.parse(path.read_text(), filename=str(path))
    parents = {child: node for node in ast.walk(tree)
               for child in ast.iter_child_nodes(node)}
    seen, bare = set(), []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr in LAUNCHES[module]:
            seen.add(node.func.attr)
            if not _under_device_guard(parents, node):
                bare.append(node.lineno)
    assert seen == LAUNCHES[module], f"launch calls not found: {seen}"
    assert not bare, f"{module}: launches outside a device guard at {bare}"
