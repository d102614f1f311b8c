"""World state, feature frontend and the tracking pipeline."""
