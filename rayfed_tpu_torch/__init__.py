"""PyTorch/CUDA port of rayfed-tpu, grown slice by slice beside the JAX package.

The JAX package ``rayfed_tpu`` is the reference: this package mirrors its
module paths and function names so each counterpart is easy to find, and
imports neither JAX nor anything of the reference.  The federated API is not
ported yet, so nothing is re-exported here.
"""

__version__ = "0.4.0"
