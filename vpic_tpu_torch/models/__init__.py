"""Built-in decks ported so far (analogues of the reference's sample/ decks)."""

from . import harris  # noqa: F401
