"""Several devices in one run (the port of stoat_tpu/parallel).

The reference's only parallelism is OpenMP threads over snarls
(the reference's src/snarl_analyzer.cpp:165).  The JAX package made it
data parallelism over the snarl axis.  The port deals whole chunks of a
chromosome's snarls over a list of devices (mesh.py ``steps``); each chunk
runs the single-device pipeline on its device.
"""

from stoat_tpu_torch.parallel.mesh import (SnarlMesh, make_snarl_mesh,
                                           resolve_mesh, steps)

__all__ = ["SnarlMesh", "make_snarl_mesh", "resolve_mesh", "steps"]
