"""One module per loop kind, named as a cell's ``loop`` names it."""
