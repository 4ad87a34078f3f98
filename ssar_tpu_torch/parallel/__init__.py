"""Long-form and (later) multi-card paths."""
