"""Host utilities shared by the entry points."""
