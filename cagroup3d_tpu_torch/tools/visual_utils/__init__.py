"""Scene rendering for the ``demo`` CLI (``headless_vis_utils``)."""
