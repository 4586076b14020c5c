"""One-off measurement tools of the port, run on the card by hand."""
