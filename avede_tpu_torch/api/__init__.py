"""REST application (aiohttp, imported inside ``create_app``)."""
