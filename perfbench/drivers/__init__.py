"""One driver per kind of entry point of the program."""
