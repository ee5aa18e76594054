"""``bigdl_tpu_torch.util``: the pyspark spelling of the util package
(counterpart of ``bigdl_tpu/util/``).

The reference's Python API lives under ``bigdl.util`` (singular); this
package mirrors that module path so user scripts port with the top-level
package rename alone. The port's utilities themselves live in
``bigdl_tpu_torch.utils`` (plural).
"""
from . import common  # noqa: F401
