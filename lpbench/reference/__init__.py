"""The plain reference: an LP solver of its own and the comparison that
decides ``correct``.  It imports nothing of the program under test."""
