"""One traffic loop per file, found by the name a cell gives."""
