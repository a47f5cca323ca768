"""Protocol core of the port: schedules, masking, the Byzantine fault
model, the plan compiler and the engine on the single-device oracle."""
