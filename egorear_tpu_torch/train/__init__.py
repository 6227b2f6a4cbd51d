"""Training of the port: optimizer and schedule, tasks, the train step."""
