"""Built-in decks ported so far (analogues of the reference's sample/ decks)."""

from . import emission, harris, lpi, reconnection, shapes, weibel  # noqa: F401
