"""The plain references the benchmark holds the program against: plain
PyTorch, importing nothing of the program (``pic``: one PIC step; one
module a deck, named by its configuration's ``reference``)."""
