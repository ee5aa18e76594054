"""The graph API of the port against the JAX package on the CPU: ``Input``,
``Node`` and graph-building calls, ``Graph`` / ``StaticGraph`` / ``Model``
(output, params and state under ``str(mod_idx)``, gradients at 1e-5),
``DynamicGraph`` with ``Switch`` / ``Merge`` down both branches, and the
directed-graph utility (``utils.DirectedGraph``, walks equal to JAX's).
Dropout inside a graph is held in evaluation mode: JAX folds each node's
index into its key, which has no bitwise counterpart in torch."""
import copy

import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu.utils import directed_graph as jdg
from bigdl_tpu.utils.table import Table as JTable
import bigdl_tpu_torch.nn as tnn
from bigdl_tpu_torch import convert, models
from bigdl_tpu_torch.utils import directed_graph as tdg
from bigdl_tpu_torch.utils.table import Table

from torch_parity_helpers import check_pair, jax_params, load, to_jax

torch.set_num_threads(1)


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def branchy(nn):
    """Linear -> ReLU, then a Linear branch and a Tanh branch summed, a
    Dropout, and a Linear head: one input, one output."""
    x = nn.Input()
    h = nn.ReLU()(nn.Linear(6, 8)(x))
    a = nn.Linear(8, 8)(h)
    b = nn.Tanh()(h)
    s = nn.CAddTable()(a, b)
    return nn.Graph(x, nn.Linear(8, 3)(nn.Dropout(0.3)(s)))


def two_in_two_out(nn):
    """Two inputs joined, two heads (a list of nodes as one argument)."""
    x1, x2 = nn.Input(name="x1"), nn.Input(name="x2")
    j = nn.JoinTable(2)([nn.Linear(4, 5)(x1), nn.Linear(3, 5)(x2)])
    return nn.Model([x1, x2], [nn.Linear(10, 2)(j), nn.Sigmoid()(j)])


def shared_input(nn):
    """One node feeding two others and an output read twice."""
    x = nn.Input()
    h = nn.Linear(5, 5)(x)
    return nn.StaticGraph([x], [nn.CMulTable()(h, nn.Tanh()(h)), h])


@pytest.mark.parametrize("build,x", [
    (branchy, _x(4, 6)),
    (two_in_two_out, [_x(4, 4), _x(4, 3, seed=1)]),
    (shared_input, _x(3, 5)),
], ids=["branchy", "two_in_two_out", "shared_input"])
def test_graph_matches_jax(build, x):
    tm = build(tnn)
    check_pair(build(jnn), tm, x, False)
    assert list(tm.params) == [str(i) for i in range(len(tm._modules))]


def test_mod_idx_is_the_topological_order_and_survives_copies():
    g = branchy(tnn)
    idx = [n.mod_idx for n in g.topo if n.module is not None]
    assert idx == list(range(len(g._modules)))
    assert all(g[n.mod_idx] is n.module for n in g.topo if n.module)
    jg = branchy(jnn)
    assert [type(n.module).__name__ for n in g.topo] == \
        [type(n.module).__name__ for n in jg.topo]
    for c in (g.clone(), copy.deepcopy(g)):
        assert [n.mod_idx for n in c.topo] == [n.mod_idx for n in g.topo]
        assert all(c[n.mod_idx] is n.module for n in c.topo if n.module)
        assert c.topo[0].module is None and c.node("input") is c.topo[0]
    x = torch.from_numpy(_x(2, 6))
    g.evaluate()
    c = g.clone().evaluate()
    assert torch.equal(c.forward(x), g.forward(x))


def test_calls_build_nodes_on_nodes_and_run_torch_on_data():
    lin = tnn.Linear(3, 2)
    n1, n2 = tnn.Input(), tnn.Input()
    node = lin(n1)
    assert isinstance(node, tnn.Node) and node.prevs == [n1]
    assert node.name == lin.name and node.mod_idx is None
    assert tnn.CAddTable()(n1, n2).prevs == [n1, n2]
    assert tnn.CAddTable()([n1, n2]).prevs == [n1, n2]
    # data goes through torch's call: its hooks fire
    seen = []
    lin.register_forward_hook(lambda m, i, o: seen.append(o.shape))
    out = lin(torch.ones(4, 3))
    assert out.shape == (4, 2) and seen == [(4, 2)]
    # several data arguments arrive as one Table, as in JAX
    add = tnn.CAddTable()
    torch.testing.assert_close(add(torch.ones(2), torch.ones(2)),
                               torch.full((2,), 2.0))


def test_graph_errors_match_jax():
    for nn in (jnn, tnn):
        x, y = nn.Input(), nn.Input()
        with pytest.raises(ValueError, match="not connected"):
            nn.Graph([x, y], nn.Linear(2, 2)(x))
        g = two_in_two_out(nn)
        with pytest.raises(ValueError, match="expects 2 inputs"):
            g.apply(g.params if nn is tnn else jax_params(g)[0],
                    g.state if nn is tnn else jax_params(g)[1],
                    [np.zeros((1, 4), np.float32)] * 3 if nn is jnn else
                    Table(*[torch.zeros(1, 4)] * 3))


def test_zoo_model_as_a_graph_is_its_sequential_twin():
    """LeNet-5 chained as a Graph over the Sequential's own modules: the
    same params keys and bit for bit the same output and gradients."""
    seq = models.LeNet5(device="cpu")
    x = tnn.Input()
    node = x
    for m in seq._modules.values():
        node = m(node)
    g = tnn.Graph(x, node)
    assert list(convert.flatten(g.params)) == list(
        convert.flatten(seq.params))
    img = torch.from_numpy(_x(4, 28, 28))
    outs = []
    for model in (seq, g):
        model.evaluate()
        p = model.params
        out, _ = model.apply(p, model.state, img)
        grads = torch.autograd.grad(out.sum(),
                                    list(convert.flatten(p).values()))
        outs.append((out, grads))
    assert torch.equal(outs[0][0], outs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(outs[0][1], outs[1][1]))


# -- DynamicGraph ----------------------------------------------------------------

def switch_graph(nn):
    """x, pred -> Switch -> (false: x * 2, true: x + 1) -> Merge."""
    x, p = nn.Input(name="x"), nn.Input(name="pred")
    sw = nn.Switch()(x, p)
    f = nn.MulConstant(2.0)(nn.SelectTable(1)(sw))
    t = nn.AddConstant(1.0)(nn.Linear(3, 3)(nn.SelectTable(2)(sw)))
    return nn.DynamicGraph([x, p], nn.Merge()(f, t))


@pytest.mark.parametrize("pred", [True, False], ids=["true", "false"])
def test_dynamic_graph_switch_merge_matches_jax(pred):
    x = _x(2, 3)
    jg, tg = switch_graph(jnn), switch_graph(tnn)
    jp, js = jax_params(jg)
    load(tg, jp, js)
    jout, _ = jg.apply(jp, js, JTable(to_jax(x), np.array(pred)))
    tout, _ = tg.apply(tg.params, tg.state,
                       Table(torch.from_numpy(x), torch.tensor(pred)))
    torch.testing.assert_close(tout, torch.from_numpy(np.asarray(jout)))
    if not pred:
        torch.testing.assert_close(tout, torch.from_numpy(2 * x))
    assert tg.jittable is False and isinstance(tg, tnn.Graph)


def test_switch_merge_and_the_untaken_output():
    sw = tnn.Switch()
    a = torch.ones(2)
    out = sw.forward(Table(a, torch.tensor(True)))
    assert out[1] is tnn.NOT_TAKEN and out[2] is a
    assert tnn.Merge().forward(Table(tnn.NOT_TAKEN, a)) is a
    with pytest.raises(ValueError, match="exactly one"):
        tnn.Merge().forward(Table(a, a))
    assert copy.deepcopy(tnn.NOT_TAKEN) is tnn.NOT_TAKEN
    # an output on the untaken branch raises, as in JAX
    for nn in (jnn, tnn):
        x, p = nn.Input(), nn.Input()
        sw = nn.Switch()(x, p)
        g = nn.DynamicGraph([x, p], nn.MulConstant(2.0)(
            nn.SelectTable(1)(sw)))
        data = Table(torch.ones(2), torch.tensor(True)) if nn is tnn \
            else JTable(np.ones(2, np.float32), np.array(True))
        with pytest.raises(ValueError, match="untaken"):
            g.apply({"0": {}, "1": {}, "2": {}}, {"0": {}, "1": {}, "2": {}},
                    data)
    assert tnn.StaticGraph is tnn.Graph and tnn.Model is tnn.Graph


# -- utils.DirectedGraph ----------------------------------------------------------

def _dag(dg):
    """a -> b, a -> c, b -> d, c -> d, d -> e (and c -> e)."""
    n = {k: dg.Node(k) for k in "abcde"}
    n["a"].add(n["b"])
    n["a"].add(n["c"], dg.Edge(1))
    n["b"].add(n["d"])
    n["c"].add(n["d"])
    n["c"].add(n["e"])
    n["d"].add(n["e"])
    return n


def test_directed_graph_walks_match_jax():
    jn, tn = _dag(jdg), _dag(tdg)
    for rev, src in ((False, "a"), (True, "e")):
        j = jdg.DirectedGraph(jn[src], reverse=rev)
        t = tdg.DirectedGraph(tn[src], reverse=rev)
        for walk in ("bfs", "dfs", "topology_sort"):
            got = [x.element for x in getattr(t, walk)()]
            assert got == [x.element for x in getattr(j, walk)()], walk
        assert (t.size(), t.edges()) == (j.size(), j.edges())
    tn["c"].delete(tn["e"])
    jn["c"].delete(jn["e"])
    tn["d"].remove_prev_edges()
    jn["d"].remove_prev_edges()
    assert [x.element for x in tdg.DirectedGraph(tn["a"]).bfs()] == \
        [x.element for x in jdg.DirectedGraph(jn["a"]).bfs()]
    assert repr(tn["a"]) == "Node(a)" and repr(tdg.Edge(2)) == "Edge(2)"
    # a cycle is refused
    tn["e"].add(tn["a"])
    tn["a"].add(tn["b"])
    tn["b"].add(tn["a"])
    with pytest.raises(ValueError, match="cycle"):
        tdg.DirectedGraph(tn["a"]).topology_sort()
    from bigdl_tpu_torch.utils import DirectedGraph, Edge, GraphNode
    assert GraphNode is tdg.Node and Edge is tdg.Edge
    assert DirectedGraph is tdg.DirectedGraph
