"""Built-in decks ported so far (analogues of the reference's sample/ decks)."""

from . import harris, lpi, weibel  # noqa: F401
