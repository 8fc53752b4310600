"""On-device randomized sketching construction of H^2 matrices.

Modules
-------
rng          counter-based Gaussian test matrices (Philox, same bits on
             the CPU and the card)
sample       batched kernel-block evaluation + block-row sketching
rangefinder  nested-basis randomized rangefinder (QR/SVD upsweep)
construct    geometric pipeline: points + torch kernel -> (H2Shape, H2Data)
blackbox     construction from only a matvec ``x -> A x`` (peeling probes)

The public entry points are ``sketch_construct`` and
``construct_from_matvec``; ``core.construction.construct_h2`` dispatches to
the former with ``method="sketch"``.
"""
from .blackbox import construct_from_matvec
from .construct import adaptive_sketches, sketch_construct
from .rangefinder import build_nested_bases, explicit_bases
from .sample import (apply_kernel_blocks, eval_dense_blocks,
                     project_coupling_blocks, sample_block_rows)

__all__ = [
    "adaptive_sketches", "apply_kernel_blocks", "build_nested_bases",
    "construct_from_matvec", "eval_dense_blocks", "explicit_bases",
    "project_coupling_blocks", "sample_block_rows", "sketch_construct",
]
