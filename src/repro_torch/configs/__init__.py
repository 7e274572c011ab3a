"""Architecture registry of the port (dyngnn archs only)."""
