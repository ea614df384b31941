"""Model families: how a configuration's weights are drawn, how the port's
loss is built from it, and which plain reference follows it."""
