"""Training on the port's models: the AdamW optimizer and its schedules
(``optimizer``), the train step (``train_loop``) and the elastic control
plane (``elastic``)."""
