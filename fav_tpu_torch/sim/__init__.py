"""Simulators of simulation mode (``anomaly_sim``, ``vision_sim``) and the
scripted camera streams of the analyzer's checks (``frames``)."""
