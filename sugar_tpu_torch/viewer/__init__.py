"""Viewer support: the network viewer protocol and the web-viewer export."""
