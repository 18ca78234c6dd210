"""PPO: the rollout, GAE, the update and its optimizer."""
