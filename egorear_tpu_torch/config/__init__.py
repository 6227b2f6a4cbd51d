"""The experiment yamls: the Lightning-CLI schema onto tasks and trainer."""
