"""vpic_tpu_torch: the PyTorch + CUDA port of vpic_tpu, for one NVIDIA GPU.

Plain tensor code is PyTorch; the particle pushes and the residency merge
are CUDA kernels written by hand for Hopper (csrc/fused_push2d.cu,
fused_push3d.cu, merge_p.cu), and so are the JAX package's prototype
kernels, the fused field trio and the residency compaction and mailbox
(csrc/field_beb.cu, compact_block.cu, mailbox.cu), each with a plain
PyTorch twin that CPU tensors use.  The entry points run on the CUDA card
unless the caller asks for the CPU.  vpic_tpu stays the reference: every
module here keeps its counterpart's name and is tested against it.

Layer map:
  deck.Simulation     -- input-deck vocabulary + step orchestration
  ops.fused_push      -- bucket sort + the 2-D CUDA push kernel
  ops.fused_push3d    -- brick sort + the 3-D CUDA push kernel (outboxes)
  ops.residency       -- per-brick residency: exchange plan + CUDA merge
  ops.field_fuse      -- the field trio as one CUDA kernel (not in the step yet)
  ops.compact         -- block compaction + mailbox copies (residency prototypes)
  scripts.*           -- the prototype kernels' entry points (python -m ...)
  ops.push            -- particle engine, plain path (advance_p/sort/energy/rho)
  ops.fields          -- Yee FDTD solver, div cleaners, BCs, synchronization
  ops.interp          -- interpolator / accumulator field<->particle interface
  interop             -- states carried across from/to vpic_tpu as numpy
"""

from .grid import (ABSORB_FIELDS, ABSORB_PARTICLES, ANTI_SYMMETRIC, BOUNDARY,
                   METAL, PEC, PERIODIC, PMC, REFLECT_PARTICLES, SYMMETRIC,
                   Grid, partition_absorbing_box, partition_metal_box,
                   partition_periodic_box)
from .state import (FieldState, MaterialCoeffs, SimState, SpeciesParams,
                    SpeciesState)
from .deck import Material, Simulation, everywhere
from .utils.log import error, message, sim_log, warning

__version__ = "0.1.0"
