"""Architecture registry of the port (dyngnn and dense LM archs)."""
