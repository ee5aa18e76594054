"""``bigdl_tpu_torch.transform.vision.image`` — the reference's module path
for every vision transform (``from bigdl.transform.vision.image import
Resize, ...`` ports with just the package rename)."""
from . import __all__                   # noqa: F401
from . import *                         # noqa: F401,F403
