"""Model configurations ported so far (DBRX-132B)."""
