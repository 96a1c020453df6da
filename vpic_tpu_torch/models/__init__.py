"""Built-in decks (analogues of the reference's sample/ decks), all fifteen
of vpic_tpu.models."""

from . import (asymm4sp, beam_plas, cygnus, dipole, emission,  # noqa: F401
               force_free, harris, lpi, reconnection, sc08, shapes,
               twostream, waveguide, weibel, weibel_gold)
