"""One module per program entry that a cell's window drives."""
