"""Host-side data transforms."""
