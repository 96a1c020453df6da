"""Built-in decks ported so far (analogues of the reference's sample/ decks)."""

from . import harris, lpi, shapes, weibel  # noqa: F401
