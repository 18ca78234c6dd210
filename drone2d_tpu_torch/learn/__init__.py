"""PPO rollout and GAE."""
