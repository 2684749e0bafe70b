"""Model configurations ported so far (DBRX-132B, DeepSeek-V3-671B)."""
