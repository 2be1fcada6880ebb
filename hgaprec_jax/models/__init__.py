from hgaprec_jax.models.state import Gam, ModelState, init_state
from hgaprec_jax.models.step import make_step

__all__ = ["Gam", "ModelState", "init_state", "make_step"]
