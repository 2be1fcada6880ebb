"""hgaprec_jax — hierarchical Gamma-Poisson factorization in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capability surface of
premgopalan/hgaprec (Gopalan, Hofman & Blei, arXiv:1311.1704): Bayesian
Poisson Factorization (BPF), hierarchical HPF, bias terms, binary
(Bernoulli-Poisson) data, and MLE/Canny GaP variants, trained by CAVI.

Design stance (vs. the reference's GPMatrix/GPMatrixGR/GPArray object zoo
with curr/next double buffers, /root/reference/src/gpbase.hh): model state is
an immutable pytree of Gamma posteriors; one CAVI iteration is a pure jitted
function `state -> state`; the reference's swap() discipline is "return the
new pytree". The per-nonzero multinomial responsibility (phi) sweep is
expressed as SDDMM + SpMM so the FLOPs land in matrix products, with
interchangeable execution paths (a fused GPU kernel, dense-blocked XLA
matmuls, a dense head plus sparse tail, segment sums).
"""

__version__ = "0.1.0"

from hgaprec_jax.config import ModelConfig, RunConfig

__all__ = ["ModelConfig", "RunConfig", "__version__"]
