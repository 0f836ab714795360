"""The port's own copy of the JAX package's ``sim/__main__.py``
(the port imports nothing of that package); names and behaviour
are the reference's.

CLI: ``python -m modelmesh_tpu_torch.sim --seed S --steps K``."""

import sys

from modelmesh_tpu_torch.sim.explore import main

if __name__ == "__main__":
    sys.exit(main())
