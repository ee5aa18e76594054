"""``bigdl_tpu_torch.util.tf_utils``: the pyspark module path (reference
``bigdl/util/tf_utils.py``; counterpart of ``bigdl_tpu/util/tf_utils.py``).

The reference's helpers marshal a live tf.Session's graph into its own
dump format for the Scala TF loader. Here TensorFlow interop lives in
``bigdl_tpu_torch.loaders`` (the GraphDef loader and saver, TFSession),
so these are thin spellings over it; ``tensorflow`` is imported inside
the functions that need it, never with the module. The module's tensors
go to ``device`` (the CUDA device by default; ``"cpu"`` for the CPU).
"""
from __future__ import annotations

__all__ = ["get_path", "convert", "dump_model"]


def get_path(output_name, sess=None):
    """Reference: writes the session's frozen GraphDef to a temp dir and
    returns the path. Requires real TensorFlow. Like the reference, a
    missing ``sess`` falls back to a fresh initialized Session over the
    default graph."""
    import os
    import tempfile

    import tensorflow as tf
    tf1 = tf.compat.v1
    owned = False
    if sess is None:
        sess = tf1.get_default_session()
    if sess is None:
        sess = tf1.Session()
        sess.run(tf1.global_variables_initializer())
        owned = True
    try:
        graph_def = tf1.graph_util.convert_variables_to_constants(
            sess, sess.graph_def, [_node_name(output_name)])
    finally:
        if owned:
            sess.close()
    d = tempfile.mkdtemp()
    path = os.path.join(d, "model.pb")
    with open(path, "wb") as f:
        f.write(graph_def.SerializeToString())
    return path


def convert(input_ops, output_ops, byte_order="little_endian",
            bigdl_type="float", graph_def=None, sess=None, device=None):
    """Convert a TF graph into a port module (reference: py4j call into
    the Scala TF loader; here: ``loaders.load_tf_graph``) on ``device``."""
    from ..loaders import load_tf_graph
    inputs = [_node_name(o) for o in (input_ops or [])] or None
    outputs = [_node_name(o) for o in (output_ops or [])] or None
    if graph_def is None:
        path = get_path(output_ops[0] if isinstance(output_ops, (list,
                                                                 tuple))
                        else output_ops, sess)
        return load_tf_graph(path, inputs=inputs, outputs=outputs,
                             device=device)
    if sess is not None and hasattr(graph_def, "node"):
        # a session means there may be live Variables: freeze them so the
        # loader (constants-only) sees their values
        import tensorflow as tf
        graph_def = tf.compat.v1.graph_util.convert_variables_to_constants(
            sess, graph_def, outputs or [])
    if hasattr(graph_def, "SerializeToString"):
        graph_def = graph_def.SerializeToString()
    return load_tf_graph(graph_def, inputs=inputs, outputs=outputs,
                         device=device)


def _node_name(op_or_name):
    """'x:0' tensor names and tf op objects -> loader node names."""
    name = getattr(op_or_name, "name", op_or_name)
    return name.split(":")[0]


def dump_model(path, graph=None, sess=None, ckpt_file=None,
               bigdl_type="float"):
    raise NotImplementedError(
        "dump_model wrote the reference's JVM-endian dump format; the "
        "native path is loaders.load_tf_graph / save_tf_graph (GraphDef "
        "in, GraphDef out) - see docs/MIGRATION.md")
