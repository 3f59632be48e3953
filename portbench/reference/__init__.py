"""Plain references that decide ``correct``.  They import nothing of the
program under test (a test holds them to that)."""
