"""Flash decode (single-token GQA attention) kernel: wrapper, plain version."""
