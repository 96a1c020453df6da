"""vpic_tpu_torch: the PyTorch + CUDA port of vpic_tpu, for one NVIDIA GPU.

Plain tensor code is PyTorch; the particle pushes, the residency merge and
the fused field trio are CUDA kernels written by hand for Hopper
(csrc/fused_push2d.cu, fused_push3d.cu, merge_p.cu, field_beb.cu), and so
are the JAX package's prototype kernels, the residency compaction and
mailbox (csrc/compact_block.cu, mailbox.cu), each with a plain
PyTorch twin that CPU tensors use; the pushes walk absorbing, custom and
region particle faces too.  The entry points run on the CUDA card
unless the caller asks for the CPU.  vpic_tpu stays the reference: every
module here keeps its counterpart's name and is tested against it.

Layer map:
  deck.Simulation     -- input-deck vocabulary + step orchestration
  models.*            -- the fifteen decks of vpic_tpu.models (harris,
                         lpi, weibel, shapes, reconnection, emission,
                         twostream, weibel_gold, beam_plas, force_free,
                         sc08, asymm4sp, dipole, waveguide, cygnus)
  collision           -- binary and unary collision ops (draw, then apply)
  emitter             -- Child-Langmuir emission, runtime and aged injection
  boundary            -- boundary_p: parked lanes to their handlers, leftovers
  boundary_ops        -- custom particle BCs (reflux, absorb tally, link)
  ops.fused_push      -- bucket sort + the 2-D CUDA push kernel
  ops.fused_push3d    -- brick sort + the 3-D CUDA push kernel (outboxes)
  ops.residency       -- per-brick residency: exchange plan + CUDA merge
  ops.field_fuse      -- the field trio as one CUDA kernel (the step's field
                         advance where it covers the deck)
  ops.compact         -- block compaction + mailbox copies (residency prototypes)
  scripts.*           -- the prototype kernels' entry points (python -m ...)
  ops.push            -- particle engine, plain path (advance_p/sort/energy/rho)
  ops.fields          -- Yee FDTD solver, div cleaners, BCs, synchronization
  ops.interp          -- interpolator / accumulator field<->particle interface
  interop             -- states carried across from/to vpic_tpu as numpy
  utils.profile       -- step-phase timers, torch.profiler traces
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
