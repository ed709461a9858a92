"""The runtime lock-order checker (`lockorder.py`), copied from the JAX
package's `analysis/`; every threaded module of the port takes its locks
from `make_lock`. The static rule families stay with the JAX package."""
